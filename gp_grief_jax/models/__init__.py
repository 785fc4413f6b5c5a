"""Models (reference L3: ``gp_grief/models.py`` — SURVEY.md §2 #15–#18)."""

from gp_grief_jax.models.base import BaseModel, BasisStats, basis_nlml, basis_posterior
from gp_grief_jax.models.gp_regression import GPRegression
from gp_grief_jax.models.gp_grief import GPGriefModel
from gp_grief_jax.models.gp_kron import GPKroneckerRegression
from gp_grief_jax.models.gp_ski import GPSKIRegression
from gp_grief_jax.models.gp_web import GPweb

__all__ = [
    "BaseModel",
    "BasisStats",
    "basis_nlml",
    "basis_posterior",
    "GPRegression",
    "GPGriefModel",
    "GPKroneckerRegression",
    "GPSKIRegression",
    "GPweb",
]
