"""Product kernels over Cartesian grids → Kronecker factor lists.

Re-design of the reference's ``GridKernel`` (reference: ``gp_grief/kern.py``,
class ``GridKernel`` — SURVEY.md §2 #12): a product kernel
``k(x, z) = Π_d k_d(x_d, z_d)`` evaluated on a product grid yields
``K_UU = ⊗_d K_d``; here that is simply a tuple of per-dimension Gram matrices
feeding the ``ops.kron`` functions.  ``dim_noise_var`` adds the reference's
per-dimension jitter for ``eigh`` stability (SURVEY.md §2 #12).

A ``GridKernelState`` is a pytree of per-dimension :class:`Stationary` kernels;
passing one kernel shares it across all dimensions (the reference's
"radial"/shared mode).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from gp_grief_jax.kernels.stationary import Stationary

__all__ = ["cov_grid", "cross_cov_grid", "product_cov"]

KernList = Sequence[Stationary]


def _kern_for_dim(kernels, d):
    # A single kernel object (anything callable, not a list/tuple) is shared
    # across dimensions — the reference's "radial" mode.
    if not isinstance(kernels, (list, tuple)):
        return kernels
    return kernels[d]


def cov_grid(
    kernels: Union[Stationary, KernList],
    xg: Sequence[jax.Array],
    *,
    dim_noise_var: float = 0.0,
) -> Tuple[jax.Array, ...]:
    """Per-dimension Gram factors of ``K_UU = ⊗_d K_d`` on grid ``xg``.

    ``xg[d]``: ``(m_d, s_d)`` per-dimension grid points.  ``dim_noise_var``
    adds ``ε·I`` per factor — the reference's eigh-stability jitter.
    """
    out = []
    for d, g in enumerate(xg):
        K = _kern_for_dim(kernels, d)(g)
        if dim_noise_var:
            K = K + dim_noise_var * jnp.eye(K.shape[0], dtype=K.dtype)
        out.append(K)
    return tuple(out)


def cross_cov_grid(
    kernels: Union[Stationary, KernList],
    x: jax.Array,
    xg: Sequence[jax.Array],
    dims: Optional[Sequence[Sequence[int]]] = None,
) -> Tuple[jax.Array, ...]:
    """Per-dimension cross-covariances ``K_xU_d = k_d(x[:, dims_d], xg[d])``.

    Returns the row-partitioned Khatri-Rao factors of ``k(x, U)`` (each
    ``(n, m_d)``) — the cross-covariance structure between scattered points and
    the grid (reference ``KhatriRaoMatrix`` use, SURVEY.md §2 #2).
    ``dims[d]`` selects the input columns belonging to grid dimension ``d``
    (default: dimension ``d`` ↦ column ``d``).
    """
    if x.ndim == 1:
        x = x[:, None]
    out = []
    for d, g in enumerate(xg):
        cols = jnp.asarray(list(dims[d])) if dims is not None else jnp.asarray([d])
        xd = x[:, cols]
        out.append(_kern_for_dim(kernels, d)(xd, g))
    return tuple(out)


def product_cov(
    kernels: Union[Stationary, KernList],
    x: jax.Array,
    z: Optional[jax.Array] = None,
    *,
    n_dims: Optional[int] = None,
) -> jax.Array:
    """Dense product-kernel Gram ``Π_d k_d(x_d, z_d)`` for scattered inputs.

    The exact-GP counterpart of the grid structure (used by the parity oracle
    and by ``GPRegression`` with a product kernel).
    """
    if x.ndim == 1:
        x = x[:, None]
    if z is not None and z.ndim == 1:
        z = z[:, None]
    d = x.shape[1] if n_dims is None else n_dims
    out = None
    for dd in range(d):
        zd = None if z is None else z[:, dd : dd + 1]
        Kd = _kern_for_dim(kernels, dd)(x[:, dd : dd + 1], zd)
        out = Kd if out is None else out * Kd
    return out
