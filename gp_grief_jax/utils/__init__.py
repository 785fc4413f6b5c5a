"""Utilities: checkpointing, structured logging (reference aux subsystems, SURVEY.md §5)."""

from gp_grief_jax.utils.checkpoint import load_pytree, save_pytree
from gp_grief_jax.utils.logging import MetricLogger
from gp_grief_jax.utils.checks import check_finite, guarded

__all__ = [
    "enable_compilation_cache","save_pytree", "load_pytree", "MetricLogger", "check_finite", "guarded"]

from gp_grief_jax.utils.compilation_cache import enable_compilation_cache
