"""gp_grief_jax — GP-GRIEF in JAX: grid-structured eigenfunction GPs.

A JAX / XLA / ``jax.sharding`` framework with the capabilities of the
reference ``scwolof/gp_grief`` (GP-GRIEF, Evans & Nair ICML 2018 — see
SURVEY.md for the full blueprint and provenance notes):

* ``ops``      — structured tensor algebra (Kronecker, Khatri-Rao, selection,
                 top-p Kronecker eigenvalues) + iterative linear algebra
                 (CG, Lanczos, stochastic Lanczos log-det) as ``lax`` pipelines.
* ``kernels``  — native JAX stationary kernels (RBF, Matérn family) with
                 hyperparameter pytrees, product/grid kernels, GRIEF
                 eigenfunction basis.
* ``models``   — ``GPRegression`` (exact), ``GPKroneckerRegression`` (on-grid),
                 ``GPGriefModel`` (O(p) inference), ``GPweb`` (weighted basis);
                 NLML optimized with ``jax.grad`` end-to-end.
* ``parallel`` — ``jax.sharding`` mesh + ``shard_map`` data-parallel training.
* ``utils``    — counters, checkpointing, structured logging.
"""

__version__ = "0.1.0"

from gp_grief_jax import kernels, models, ops, optimize
from gp_grief_jax.grid import InducingGrid
from gp_grief_jax.kernels import make_kernel
from gp_grief_jax.models import (
    GPGriefModel,
    GPKroneckerRegression,
    GPRegression,
    GPSKIRegression,
    GPweb,
)

__all__ = [
    "ops",
    "kernels",
    "models",
    "optimize",
    "InducingGrid",
    "make_kernel",
    "GPRegression",
    "GPGriefModel",
    "GPKroneckerRegression",
    "GPSKIRegression",
    "GPweb",
    "__version__",
]
