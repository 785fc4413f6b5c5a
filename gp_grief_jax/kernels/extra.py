"""Extended kernel zoo: non-Matérn stationary, non-stationary, and combinators.

The reference reaches any kernel GPy exposes through its ``GPyKernel`` adapter
(SURVEY.md §2 #11); natively we cover the kernels GP practice actually uses:
rational quadratic, periodic (ExpSineSquared), cosine, white noise, constant
(bias), linear (dot-product), plus ``Sum`` / ``Product`` combinators closed
under each other and over the ``Stationary`` family.  Every kernel is a frozen
pytree dataclass with log-space raw parameters (exact ``jax.grad``), callable
as ``k(x, z=None) -> Gram``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gp_grief_jax.kernels.base import inverse_positive, param_dataclass, positive
from gp_grief_jax.kernels.stationary import _sq_dist

__all__ = [
    "RatQuad",
    "Periodic",
    "Cosine",
    "White",
    "Constant",
    "Linear",
    "Sum",
    "Product",
]


def _prep(x, z):
    if x.ndim == 1:
        x = x[:, None]
    same = z is None
    z = x if same else (z[:, None] if z.ndim == 1 else z)
    return x, z, same


@param_dataclass
class RatQuad:
    """Rational quadratic: ``σ² (1 + r²/(2αℓ²))^{-α}`` (scale-mixture of RBFs)."""

    log_lengthscale: jax.Array
    log_variance: jax.Array
    log_alpha: jax.Array

    def __call__(self, x, z=None):
        x, z, same = _prep(x, z)
        ls = jnp.broadcast_to(positive(self.log_lengthscale), (x.shape[-1],))
        r2 = _sq_dist(x / ls, z / ls, same)
        alpha = positive(self.log_alpha)
        return positive(self.log_variance) * (1.0 + r2 / (2.0 * alpha)) ** (-alpha)


@param_dataclass
class Periodic:
    """ExpSineSquared: ``σ² exp(−2 sin²(π r / T) / ℓ²)`` (1-D inputs)."""

    log_lengthscale: jax.Array
    log_variance: jax.Array
    log_period: jax.Array

    def __call__(self, x, z=None):
        x, z, _ = _prep(x, z)
        r = jnp.abs(x[:, :1] - z[:, :1].T)
        s = jnp.sin(jnp.pi * r / positive(self.log_period)) / positive(self.log_lengthscale)
        return positive(self.log_variance) * jnp.exp(-2.0 * s * s)


@param_dataclass
class Cosine:
    """``σ² cos(2π r / T)`` (1-D inputs)."""

    log_variance: jax.Array
    log_period: jax.Array

    def __call__(self, x, z=None):
        x, z, _ = _prep(x, z)
        r = x[:, :1] - z[:, :1].T
        return positive(self.log_variance) * jnp.cos(2.0 * jnp.pi * r / positive(self.log_period))


@param_dataclass
class White:
    """White noise: ``σ²·1[x == z]`` — the identity on one input set, and the
    exact coincidence indicator across two.

    The explicit-``z`` branch must detect coincident PAIRS, not return zero:
    the matrix-free Gram matvec evaluates ``k(x_block, x)`` with ``z≠None``,
    where a blanket zero would silently drop the White diagonal from the
    operator while ``cov_diag`` still includes it (round-4 review).  The
    per-dim equality product keeps the peak intermediate at one (n, m)
    block, never (n, m, d)."""

    log_variance: jax.Array

    def __call__(self, x, z=None):
        x, z, same = _prep(x, z)
        if same:
            return positive(self.log_variance) * jnp.eye(x.shape[0], dtype=x.dtype)
        eq = jnp.ones((x.shape[0], z.shape[0]), dtype=bool)
        for k in range(x.shape[1]):
            eq = eq & (x[:, k, None] == z[None, :, k])
        return positive(self.log_variance) * eq.astype(x.dtype)


@param_dataclass
class Constant:
    """Bias kernel: ``σ² · 1``."""

    log_variance: jax.Array

    def __call__(self, x, z=None):
        x, z, _ = _prep(x, z)
        return positive(self.log_variance) * jnp.ones((x.shape[0], z.shape[0]), dtype=x.dtype)


@param_dataclass
class Linear:
    """Dot-product kernel: ``Σ_d σ_d² x_d z_d`` (ARD variances)."""

    log_variances: jax.Array  # (d,) or scalar

    def __call__(self, x, z=None):
        x, z, _ = _prep(x, z)
        w = jnp.broadcast_to(positive(self.log_variances), (x.shape[-1],))
        return (x * w) @ z.T


@param_dataclass
class Sum:
    """``k₁ + k₂`` (nest for more terms)."""

    k1: object
    k2: object

    def __call__(self, x, z=None):
        return self.k1(x, z) + self.k2(x, z)


@param_dataclass
class Product:
    """``k₁ · k₂`` (elementwise)."""

    k1: object
    k2: object

    def __call__(self, x, z=None):
        return self.k1(x, z) * self.k2(x, z)


def make_ratquad(lengthscale=1.0, variance=1.0, alpha=1.0, input_dim=None):
    ls = jnp.asarray(lengthscale, dtype=jnp.result_type(float))
    if input_dim is not None and ls.ndim == 0:
        ls = jnp.full((input_dim,), ls)
    return RatQuad(
        log_lengthscale=inverse_positive(ls),
        log_variance=inverse_positive(variance),
        log_alpha=inverse_positive(alpha),
    )


def make_periodic(lengthscale=1.0, variance=1.0, period=1.0):
    return Periodic(
        log_lengthscale=inverse_positive(lengthscale),
        log_variance=inverse_positive(variance),
        log_period=inverse_positive(period),
    )
