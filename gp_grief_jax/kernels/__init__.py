"""Native JAX kernels + grid/GRIEF structure (reference L2: ``gp_grief/kern.py``)."""

from gp_grief_jax.kernels.base import inverse_positive, param_dataclass, positive
from gp_grief_jax.kernels.stationary import KERNEL_KINDS, Stationary, cov, make_kernel
from gp_grief_jax.kernels.grid import cov_grid, cross_cov_grid, product_cov
from gp_grief_jax.kernels.grief import GriefBasis, build_basis, phi
from gp_grief_jax.kernels.diag import cov_diag
from gp_grief_jax.kernels.extra import (
    Constant,
    Cosine,
    Linear,
    Periodic,
    Product,
    RatQuad,
    Sum,
    White,
    make_periodic,
    make_ratquad,
)

__all__ = [
    "cov_diag",
    "RatQuad",
    "Periodic",
    "Cosine",
    "White",
    "Constant",
    "Linear",
    "Sum",
    "Product",
    "make_ratquad",
    "make_periodic",
    "Stationary",
    "make_kernel",
    "cov",
    "KERNEL_KINDS",
    "cov_grid",
    "cross_cov_grid",
    "product_cov",
    "GriefBasis",
    "build_basis",
    "phi",
    "positive",
    "inverse_positive",
    "param_dataclass",
]
