"""Diagonal-only kernel evaluation: ``k(x_i, x_i)`` without the (n,n) Gram.

Predictive-variance code needs only ``diag k(X*, X*)``; stationary kernels
make that a constant and composites reduce recursively.  The generic fallback
evaluates 1×1 covariances under ``vmap`` — still O(n) instead of O(n²).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gp_grief_jax.kernels import extra
from gp_grief_jax.kernels.base import positive
from gp_grief_jax.kernels.stationary import Stationary

__all__ = ["cov_diag"]


def cov_diag(kern, x: jax.Array, dims=None) -> jax.Array:
    """``diag k(x, x)`` for any kernel object or per-dim kernel list.

    ``dims[d]`` selects the input columns belonging to per-dim kernel ``d``
    (grouped grid dimensions — default: kernel ``d`` ↦ column ``d``)."""
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if isinstance(kern, (list, tuple)):
        out = jnp.ones((n,), dtype=x.dtype)
        for d, k in enumerate(kern):
            cols = (
                x[:, jnp.asarray(list(dims[d]))]
                if dims is not None
                else x[:, d : d + 1]
            )
            out = out * cov_diag(k, cols)
        return out
    if isinstance(kern, (Stationary, extra.RatQuad, extra.Periodic)):
        return jnp.broadcast_to(positive(kern.log_variance), (n,)).astype(x.dtype)
    if isinstance(kern, extra.Cosine):
        return jnp.broadcast_to(positive(kern.log_variance), (n,)).astype(x.dtype)
    if isinstance(kern, (extra.White, extra.Constant)):
        return jnp.broadcast_to(positive(kern.log_variance), (n,)).astype(x.dtype)
    if isinstance(kern, extra.Linear):
        w = jnp.broadcast_to(positive(kern.log_variances), (x.shape[-1],))
        return jnp.sum(x * x * w, axis=-1)
    if isinstance(kern, extra.Sum):
        return cov_diag(kern.k1, x) + cov_diag(kern.k2, x)
    if isinstance(kern, extra.Product):
        return cov_diag(kern.k1, x) * cov_diag(kern.k2, x)
    # Generic fallback: per-point 1×1 covariance under vmap.
    return jax.vmap(lambda xi: kern(xi[None, :])[0, 0])(x)
