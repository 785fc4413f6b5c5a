"""Native stationary kernels: RBF and the Matérn family, with ARD lengthscales.

Replaces the reference's ``GPyKernel`` adapter (reference: ``gp_grief/kern.py``,
class ``GPyKernel`` — SURVEY.md §2 #11): the reference outsources 1D kernel
evaluations *and their analytic gradients* to GPy; here the kernels are ~20
lines of jnp each and ``jax.grad`` supplies exact gradients end-to-end
(BASELINE.json north star: "jax.grad end-to-end instead of finite
differences").  All evaluations are distance-matrix + elementwise math — the
distance matrix is one matmul (``x·zᵀ``) plus rank-1 updates, and the
elementwise tail fuses into it under XLA.

Supported kinds (superset of the kernels the reference's demos use): ``rbf``,
``exponential`` (= Matérn-1/2), ``matern12``, ``matern32``, ``matern52``.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from gp_grief_jax.kernels.base import inverse_positive, param_dataclass, positive

__all__ = ["Stationary", "make_kernel", "KERNEL_KINDS"]

KERNEL_KINDS = ("rbf", "exponential", "matern12", "matern32", "matern52")

# GPy-style spelling aliases (the reference passes GPy kernel names through
# its GPyKernel adapter — SURVEY.md §2 #11).
_KIND_ALIASES = {
    "expquad": "rbf",
    "squaredexponential": "rbf",
    "sqexp": "rbf",
    "exponential": "exponential",
    "mat12": "matern12",
    "mat32": "matern32",
    "mat52": "matern52",
    "ou": "matern12",
}


@param_dataclass
class Stationary:
    """A stationary kernel ``σ² g(r/ℓ)`` as a hyperparameter pytree.

    ``log_lengthscale`` has shape ``(input_dim,)`` (ARD) or ``()`` (isotropic);
    ``log_variance`` is scalar.  ``kind`` is static metadata.
    """

    log_lengthscale: jax.Array
    log_variance: jax.Array
    kind: str

    __static_fields__ = ("kind",)

    @property
    def lengthscale(self) -> jax.Array:
        return positive(self.log_lengthscale)

    @property
    def variance(self) -> jax.Array:
        return positive(self.log_variance)

    def __call__(self, x: jax.Array, z: Optional[jax.Array] = None) -> jax.Array:
        return cov(self, x, z)


def make_kernel(
    kind: str = "rbf",
    *,
    lengthscale: Union[float, jax.Array] = 1.0,
    variance: float = 1.0,
    input_dim: Optional[int] = None,
) -> Stationary:
    """Factory mirroring the reference's ``GPyKernel(input_dim, kernel=...)``.

    ``input_dim`` with an ARD request broadcasts a scalar lengthscale to a
    per-dimension vector.
    """
    kind = kind.lower().replace("-", "").replace("_", "")
    kind = _KIND_ALIASES.get(kind, kind)
    if kind not in KERNEL_KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of {KERNEL_KINDS}")
    ls = jnp.asarray(lengthscale, dtype=jnp.result_type(float))
    if input_dim is not None and ls.ndim == 0:
        ls = jnp.full((input_dim,), ls)
    return Stationary(
        log_lengthscale=inverse_positive(ls),
        log_variance=inverse_positive(variance),
        kind=kind,
    )


_EXACT_DIST_MAX_DIM = 4
# Broadcast cap: the exact path materializes an (n, m, d) intermediate — d×
# the matmul form's O(n·m).  2^24 output elements ≈ 256 MB of intermediate at
# d=4/f32; beyond that the matmul form wins on memory AND time (GPRegression
# with d≤4 data at n=50k+ would otherwise build O(n²·d)).
_EXACT_DIST_MAX_ELEMS = 1 << 24


def _use_broadcast_dist(n: int, m: int, d: int) -> bool:
    return d <= _EXACT_DIST_MAX_DIM and n * m <= _EXACT_DIST_MAX_ELEMS


def _sq_dist(xs: jax.Array, zs: jax.Array, same: bool) -> jax.Array:
    """Pairwise squared distances of pre-scaled inputs ``(n,d)×(m,d)→(n,m)``.

    Two regimes: for ≤4 features AND ≤2^24 output elements, exact broadcasted
    differences (cheap, no cancellation — the per-grid-dimension case is
    always here); otherwise, mean-centered ``‖x‖² + ‖z‖² − 2x·zᵀ`` — one
    matmul plus rank-1 terms, clipped at 0, with an exactly-zero diagonal
    when ``same`` (the Matérn ``sqrt`` would otherwise amplify the ~eps
    cancellation residue).
    """
    if _use_broadcast_dist(xs.shape[0], zs.shape[0], xs.shape[-1]):
        d = xs[:, None, :] - zs[None, :, :]
        return jnp.sum(d * d, axis=-1)
    mean = jnp.mean(xs, axis=0, keepdims=True)
    xs = xs - mean
    zs = zs - mean
    x2 = jnp.sum(xs * xs, axis=-1)
    z2 = jnp.sum(zs * zs, axis=-1)
    cross = xs @ zs.T
    scale = x2[:, None] + z2[None, :]
    r2 = jnp.maximum(scale - 2.0 * cross, 0.0)
    # Snap sub-cancellation-noise values to EXACT zero: a computed r² below
    # ~eps·(‖x̃‖²+‖z̃‖²) is indistinguishable from a coincident pair, and the
    # residue would otherwise bias Matérn's √r² by ~√eps on self-pairs —
    # the matrix-free Gram matvec evaluates k(x_block, x) with z≠None, so
    # the `same` diagonal guard alone cannot cover them (round-4 review).
    eps = jnp.finfo(r2.dtype).eps
    r2 = jnp.where(r2 <= 16.0 * eps * scale, 0.0, r2)
    if same:
        r2 = jnp.fill_diagonal(r2, 0.0, inplace=False)
    return r2


def cov(k: Stationary, x: jax.Array, z: Optional[jax.Array] = None) -> jax.Array:
    """Gram matrix ``k(x, z)``; ``x``: ``(n, d)``, ``z``: ``(m, d)`` or None.

    Mirrors the reference's ``BaseKernel.cov(x, z=None)`` signature.
    """
    if x.ndim == 1:
        x = x[:, None]
    same = z is None
    if same:
        z = x
    elif z.ndim == 1:
        z = z[:, None]
    ls = jnp.broadcast_to(k.lengthscale, (x.shape[-1],))
    xs = x / ls
    zs = z / ls
    r2 = _sq_dist(xs, zs, same)
    var = k.variance

    if k.kind == "rbf":
        return var * jnp.exp(-0.5 * r2)

    # Matérn family needs r; sqrt(0) has an infinite grad, so guard the zero
    # diagonal and restore exact zeros after.
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    r = jnp.where(r2 > 0, r, 0.0)
    if k.kind in ("exponential", "matern12"):
        return var * jnp.exp(-r)
    if k.kind == "matern32":
        s = jnp.sqrt(3.0) * r
        return var * (1.0 + s) * jnp.exp(-s)
    if k.kind == "matern52":
        s = jnp.sqrt(5.0) * r
        return var * (1.0 + s + s * s / 3.0) * jnp.exp(-s)
    raise ValueError(f"unknown kernel kind {k.kind!r}")
