"""Data-parallel GP-GRIEF training over a device mesh (`shard_map` + psum).

New design surface with no reference counterpart (SURVEY.md §2 parallelism
census): the reference scales *algorithmically* (Kronecker structure +
eigenfunction truncation); here the remaining ``O(n)`` work — feature
evaluation and the ``ΦᵀΦ`` / ``Φᵀy`` reductions — is sharded over the data
axis of a mesh, with the p×p reductions ``psum``-ed across devices:

    device k holds rows X_k, y_k:
        Φ_k = φ(X_k)                     (local: d matmuls + gathers)
        C   = Σ_k Φ_kᵀ Φ_k   → psum      (p×p, one collective)
        v   = Σ_k Φ_kᵀ y_k   → psum      (p,)
    every device then computes the identical O(p³) NLML and its gradient.

The basis build itself is replicated (it is O(Σ m_d³), tiny) — or, with a 2-D
``(data, model)`` mesh, its batched per-dimension ``eigh`` is sharded over the
``model`` axis via a sharding constraint (see ``stacked_eigh_sharded``).

Everything is differentiable: ``jax.grad`` flows through ``shard_map`` and the
psums, so one jitted program computes the sharded NLML *and* its gradient with
two reductions total per step.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gp_grief_jax.kernels.grief import GriefBasis, build_basis, phi
from gp_grief_jax.models.base import BasisStats, basis_nlml, gram
from gp_grief_jax.ops.kron_fast import kron_matvec_fast

__all__ = [
    "pad_to_multiple",
    "sharded_basis_stats",
    "sharded_grief_nlml",
    "stacked_eigh_sharded",
    "kron_matvec_sharded",
]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros along ``axis`` to a multiple; return (padded, mask).

    The mask (1 real / 0 pad) is applied as a row weight: padded rows then
    contribute nothing to ``ΦᵀΦ``/``Φᵀy``/``yᵀy``.
    """
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    pad_n = target - n
    mask = np.ones((target,), dtype=x.dtype)
    if pad_n:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad_n)
        x = np.pad(x, widths)
        mask[n:] = 0.0
    return x, mask


def sharded_basis_stats(
    basis: GriefBasis,
    kernels,
    xg,
    x: jax.Array,
    y: jax.Array,
    row_mask: jax.Array,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    n_real: Optional[int] = None,
    dims=None,
) -> BasisStats:
    """``BasisStats`` with rows of ``(x, y)`` sharded over ``axis_name``.

    ``dims``: optional grouping of input columns into grid dimensions (the
    reference's ``sub_dim`` capability) — forwarded to the local ``phi``
    evaluation; the psum reductions are unchanged.
    """
    n = int(n_real if n_real is not None else x.shape[0])

    def local(xk, yk, mk):
        Phik = phi(basis, kernels, xg, xk, dims=dims) * mk[:, None]
        yk = yk * mk
        C = lax.psum(gram(Phik.T, Phik), axis_name)
        v = lax.psum(gram(Phik.T, yk), axis_name)
        yy = lax.psum(jnp.dot(yk, yk), axis_name)
        return C, v, yy

    spec_rows = P(axis_name)
    C, v, yy = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), spec_rows, spec_rows),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(x, y, row_mask)
    return BasisStats(C=C, v=v, yy=yy, n=n)


def sharded_grief_nlml(
    params,
    xg,
    x: jax.Array,
    y: jax.Array,
    row_mask: jax.Array,
    mesh: Mesh,
    *,
    n_eigs: int,
    dim_noise_var: float = 1e-12,
    axis_name: str = "data",
    n_real: Optional[int] = None,
    dims=None,
) -> jax.Array:
    """Full data-parallel NLML: replicated basis build + sharded reductions.

    ``params``: ``{"kernels": [...], "log_w": (p,), "log_noise": ()}`` —
    differentiable end to end, including through the basis build
    (``opt_kernel_params`` semantics).
    """
    basis = build_basis(params["kernels"], xg, n_eigs, dim_noise_var=dim_noise_var)
    stats = sharded_basis_stats(
        basis, params["kernels"], xg, x, y, row_mask, mesh,
        axis_name=axis_name, n_real=n_real, dims=dims,
    )
    return basis_nlml(stats, params["log_w"], params["log_noise"])


def kron_matvec_sharded(
    factors,
    v: jax.Array,
    mesh: Mesh,
    *,
    axis_name: str = "model",
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Model-parallel ``(⊗_d K_d) @ v``: the lattice's leading axis is sharded
    over ``axis_name`` (SURVEY.md §2 parallelism table, tensor/model row).

    Device ``k`` holds rows ``a_1 ∈ block_k`` of the lattice.  The trailing
    factors ``K_2..K_d`` act within a row block (local ``kron_matvec_fast``
    with the row block as the batch); the leading factor mixes blocks, done as
    one ``psum_scatter``: each device forms its column-slice partial
    ``K_1[:, block_k] @ y_k`` and the reduce-scatter returns exactly its
    output rows.  One collective per matvec; compute is perfectly balanced.

    ``v``: ``(M,)`` or ``(M, B)``; ``m_1`` must divide by the mesh axis size.
    Note: the transient partial is ``(m_1, m/m_1)`` per device — traffic-
    optimal; chunk the trailing axis when per-device memory, not bandwidth,
    binds.
    """
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    B = int(v2.shape[1])
    m1 = int(factors[0].shape[1])
    m1o = int(factors[0].shape[0])
    R = int(v2.shape[0]) // m1
    km = mesh.shape[axis_name]
    if m1 % km or m1o % km:
        raise ValueError(f"leading factor size {m1}->{m1o} must divide mesh axis {km}")
    rest = tuple(factors[1:])
    K1 = factors[0]
    x3 = v2.reshape(m1, R, B)

    def local(K1_rep, xk):
        # xk: (m1/km, R, B) — trailing factors act per leading row.
        m1_loc = xk.shape[0]
        if rest:
            xrows = jnp.moveaxis(xk, 0, -1).reshape(R, B * m1_loc)
            yrows = kron_matvec_fast(rest, xrows, precision=precision)
            Ro = yrows.shape[0]
            yk = jnp.moveaxis(yrows.reshape(Ro, B, m1_loc), -1, 0)  # (m1_loc, Ro, B)
        else:
            yk, Ro = xk, R
        j = lax.axis_index(axis_name)
        K1_cols = lax.dynamic_slice_in_dim(K1_rep, j * m1_loc, m1_loc, axis=1)
        partial = jnp.tensordot(
            K1_cols, yk, axes=[[1], [0]], precision=precision
        )  # (m1o, Ro, B) — this device's column-slice contribution
        return lax.psum_scatter(partial, axis_name, scatter_dimension=0, tiled=True)

    out = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis_name, None, None)),
        out_specs=P(axis_name, None, None),
        check_vma=False,
    )(K1, x3)
    out = out.reshape(-1, B)
    return out[:, 0] if squeeze else out


def stacked_eigh_sharded(Ks: jax.Array, mesh: Mesh, axis_name: str = "model"):
    """Batched symmetric eigh of stacked equal-size factors ``(d, m, m)``,
    sharded over the ``model`` mesh axis (model parallelism over grid
    dimensions — SURVEY.md §2 parallelism table, "tensor/model parallelism").

    A sharding constraint on the batch axis lets XLA place each factor's
    ``eigh`` on its owning device and all-gather only the small results.
    """
    sharding = NamedSharding(mesh, P(axis_name, None, None))
    Ks = lax.with_sharding_constraint(Ks, sharding)
    lams, Qs = jax.vmap(jnp.linalg.eigh)(Ks)
    rep = NamedSharding(mesh, P())
    return (
        lax.with_sharding_constraint(Qs, rep),
        lax.with_sharding_constraint(lams, rep),
    )
