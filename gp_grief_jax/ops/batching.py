"""Batch-size padding wrapper for iterated batched operator applies.

Every solver-facing batched operator routes through :func:`safe_batch_op`:
batch sizes ``B > 8`` that are not a multiple of 8 are padded with zero
rows to the next multiple of 8 (exact for linear operators — zero rows stay
zero and real rows are untouched), then sliced back.  The pad is a
static-shape decision, so other batch sizes compile to the original program
with zero overhead.

It was introduced against run-to-run nondeterminism of such applies at
those batch extents on the previous accelerator's compiler; whether the GPU
needs it is an open question (ROADMAP 3b) — it stays because it is exact
and free.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["safe_batch_pad", "safe_batch_op"]


def safe_batch_pad(B: int) -> int:
    """Zero rows to append so a ``(B, m)`` iterated apply avoids the padded
    extents (``B > 8 and B % 8 != 0``)."""
    return 0 if B <= 8 else (-B) % 8


def safe_batch_op(
    op: Callable[[jax.Array], jax.Array],
) -> Callable[[jax.Array], jax.Array]:
    """Wrap a LINEAR batched apply ``(B, m) → (B, m)`` so it never executes
    at an unsafe batch extent — see module docstring.  Identity for safe
    ``B`` (static decision, no runtime cost)."""

    def wrapped(v_bm: jax.Array) -> jax.Array:
        B = int(v_bm.shape[0])
        pad = safe_batch_pad(B)
        if pad == 0:
            return op(v_bm)
        vp = jnp.concatenate(
            [v_bm, jnp.zeros((pad, v_bm.shape[1]), v_bm.dtype)], axis=0
        )
        return op(vp)[:B]

    return wrapped
