"""Kronecker matvec as a chain of grouped cyclic GEMM passes.

``(⊗_d K_d) v`` is applied one (super-)factor at a time:

1. **Adjacent-factor grouping**: neighbouring factors merge into
   super-factors up to ``target_width`` wide (``K_i ⊗ K_{i+1}``
   materialized — a few MB), so each pass is one larger matrix product and
   the pass count (each pass reads and writes the whole vector) falls.
   The default width follows the precision (:data:`GROUP_WIDTH`).
2. **Cyclic rotation passes**: ``X ← (K_g · X)ᵀ`` with ``X = v.reshape(m_g,
   m/m_g)`` — after one pass per (super-)factor in order, the lattice
   ordering is restored.  The transpose is folded into one ``dot_general``
   (contract lhs dim 0), so no separate transpose pass is materialized.

Effective bandwidth is reported against the ``2·d·m·itemsize`` traffic of
the ungrouped d-pass chain (``bench.py``, ``chip_smoke.py`` phase B).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["group_factors", "kron_matvec_fast"]

NARROW_PASS = 128
"""Passes narrower than this always run at ``HIGHEST`` (see the loop)."""

GROUP_WIDTH = {"exact": 64, "fast": 1024}
"""Default super-factor width: ``"fast"`` at ``Precision.DEFAULT`` (an f32
product runs in TF32 on the tensor cores), ``"exact"`` otherwise (true f32
at ``HIGHEST``, outside the tensor cores).

One matvec in ms on an NVIDIA H100 80GB HBM3 at a 700 W power limit
(``chip_smoke.py`` phase B), by group width:

=======  ======================  =======================
lattice  HIGHEST: 1 / 64 / 1024  DEFAULT: 1 / 256 / 1024
=======  ======================  =======================
8⁸       0.97 / 0.36 / 0.98      0.96 / 0.35 / 0.25
16⁶      0.50 / 0.54 / 0.62      0.50 / 0.21 / 0.21
32⁵      0.65 / 0.66 / 2.97      0.66 / 0.68 / 0.61
=======  ======================  =======================

(16⁶ and 32⁵ do not merge at width 64: the same program as width 1.)  In
true f32 a group wider than ~64 turns a pass compute-bound; in TF32 the
wide groups stay bandwidth-bound and save passes.  On a card held to 400 W
the DEFAULT 32⁵ row read 0.68 / 0.68 / 0.75 and a 9·32⁴ batch 0.25 / 0.25
/ 0.19: width 1024 loses there by 10% on one shape and wins on the rest.
"""


def _kron2(A: jax.Array, B: jax.Array) -> jax.Array:
    a0, a1 = A.shape
    b0, b1 = B.shape
    return (A[:, None, :, None] * B[None, :, None, :]).reshape(a0 * b0, a1 * b1)


def group_factors(
    factors: Sequence[jax.Array],
    target_width: int = 1024,
    max_width: int = 2048,
) -> Tuple[jax.Array, ...]:
    """Greedily merge adjacent square factors into ~``target_width`` blocks."""
    out = []
    cur = None
    for K in factors:
        if K.shape[0] != K.shape[1]:
            if cur is not None:
                out.append(cur)
                cur = None
            out.append(K)
            continue
        if cur is None:
            cur = K
        elif int(cur.shape[1]) * int(K.shape[1]) <= max_width:
            cur = _kron2(cur, K)
        else:
            out.append(cur)
            cur = K
        if cur is not None and int(cur.shape[1]) >= target_width:
            out.append(cur)
            cur = None
    if cur is not None:
        out.append(cur)
    return tuple(out)


def kron_matvec_fast(
    factors: Sequence[jax.Array],
    v: jax.Array,
    *,
    target_width: int | None = None,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """``(⊗_d K_d) @ v`` via the grouped cyclic chain (module docstring).

    ``v``: ``(M,)`` or ``(M, B)``.  Jittable, differentiable.

    Adjacent square factors merge while the group stays at most
    ``target_width`` wide; ``None`` takes :data:`GROUP_WIDTH` for the
    precision (``"fast"`` at ``Precision.DEFAULT``, ``"exact"`` otherwise).

    ``precision`` applies to every pass at least ``NARROW_PASS`` wide:
    ``HIGHEST`` (default) is exact f32 (rel err ~1e-7) — the solver
    default; ``Precision.DEFAULT`` lets an f32 product run in TF32 on the
    GPU's tensor cores (rel err ~1e-3), the operating point of the
    refined-CG inner loop (``ops.cg.cg_solve_refined``), whose exact
    residual refreshes restore full solution accuracy.  A
    ``lax.DotAlgorithmPreset`` is passed through unchanged.
    """
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    if precision is None:
        precision = lax.Precision.DEFAULT
    elif isinstance(precision, str):
        precision = lax.Precision(precision)
    B = int(v.shape[1])
    if target_width is None:
        fast = precision == lax.Precision.DEFAULT
        target_width = GROUP_WIDTH["fast" if fast else "exact"]
    gf = group_factors(factors, target_width=target_width, max_width=target_width)
    rows = math.prod(int(K.shape[0]) for K in gf)

    # Cyclic rotation: each pass contracts the (currently) leading
    # super-factor and writes it trailing, so after one pass per factor the
    # order is restored.  The inert batch axis ends up in front.  The
    # contraction is ``(K·X)ᵀ`` expressed directly as one dot_general
    # (contract lhs dim 0), so no transpose is materialized.
    x = v
    for K in gf:
        mk = int(K.shape[1])
        X = x.reshape(mk, -1)  # (mk, rest·B)
        # A narrow pass is bandwidth-bound even in true f32: the 5×32²
        # chain took 0.70 ms at HIGHEST and at DEFAULT on an H100 (400 W),
        # so the requested (fast) precision only applies to wide groups.
        pass_prec = precision if mk >= NARROW_PASS else lax.Precision.HIGHEST
        # lax.dot_general is dtype-strict: a low-precision input vector (e.g.
        # a bf16 solver state, ops/cg.py state_dtype) meets f32 factors here —
        # cast the factor to the vector dtype (a bf16 input already implies
        # the fast operating point; an x64 input keeps full precision).
        x = lax.dot_general(
            X, K.astype(X.dtype), (((0,), (1,)), ((), ())), precision=pass_prec
        )  # (rest·B, mk')
    out = x.reshape(B, rows)
    if squeeze:
        return out[0]
    return out.T


