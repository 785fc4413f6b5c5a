"""Selection (subset-of-identity) operators as index arrays + gathers.

The reference wraps row selection in ``SelectionMatrix`` /
``SelectionMatrixSparse`` classes backed by ``scipy.sparse`` (reference:
``gp_grief/tensors.py`` — SURVEY.md §2 #4).  Here a selection matrix is just
an ``int32`` index vector: ``S @ x`` is `jnp.take` (a gather) and ``Sᵀ @ u`` is
a scatter-add — both native XLA ops.  No sparse-matrix machinery needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["select_rows", "select_rows_t", "selection_expand"]


def select_rows(indices: jax.Array, x: jax.Array) -> jax.Array:
    """``S @ x``: pick rows ``x[indices]``.  ``x``: ``(m, ...)`` → ``(k, ...)``."""
    return jnp.take(x, indices, axis=0)


def select_rows_t(indices: jax.Array, u: jax.Array, m: int) -> jax.Array:
    """``Sᵀ @ u``: scatter rows of ``u`` (shape ``(k, ...)``) into ``m`` rows."""
    out = jnp.zeros((m,) + u.shape[1:], dtype=u.dtype)
    return out.at[indices].add(u)


def selection_expand(indices: jax.Array, m: int) -> jax.Array:
    """Densify ``S`` to ``(k, m)`` — test oracle only."""
    return jnp.eye(m, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)[
        indices
    ]
