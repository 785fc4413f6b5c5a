"""``WᵀW`` as a ``3^d``-offset lattice stencil (the n ≳ m hot-loop fusion).

The lattice-dual SKI operator's hot composition is ``Wᵀ(W(v))``
(:meth:`gp_grief_jax.models.gp_ski.GPSKIRegression._make_lattice_ops`): both
halves are irregular point↔lattice maps, gather- and scatter-bound and
proportional to n.

This module removes the points from the loop entirely.  ``WᵀW`` is itself a
**lattice stencil**: ``(WᵀW)[c, c'] = Σ_i w_c(x_i)·w_{c'}(x_i)`` is nonzero
only when cells ``c, c'`` are corners of a common data cell, i.e.
``c' − c ∈ {−1, 0, 1}^d`` in grid coordinates — at most ``3^d`` flat-index
offsets ``δ``.  Precomputing per-offset coefficient tables

    A_δ[c] = Σ_i w_c(x_i) · w_{c+δ}(x_i)            (once per model)

turns the apply into ``out[c] = Σ_δ A_δ[c] · v[c + δ]`` — ``D ≤ 3^d``
shifted multiply-adds over the lattice, sequential reads only, no gathers,
no scatters, and **no dependence on the kernel hyperparameters** (``W`` is
geometry-only), so the tables never rebuild during training.

Flat-shift safety: every corner's flat index is exactly ``base + const``
(:class:`gp_grief_jax.ops.interp.CornerStream` invariant: ``interp_weights``
clamps ``left ≤ m_d − 2`` and zero-weights degenerate dims), so a table
entry exists only where ``c`` and ``c + δ`` are corners of one real point's
cell.  Cells where a flat shift would wrap across a dimension boundary get
``A_δ[c] = 0`` — the apply reads plain flat shifts of a zero-padded ``v``
with no validity masks.

Cost per apply: the ``D·M`` table read plus ``B`` reads and writes of the
lattice vector — one XLA loop fusion (:func:`_apply_xla`).

Reference parity note: the reference has no counterpart (its SKI-style ``W``
composition is SURVEY.md §2 #2/#4 sparse products); this is a re-expression
of the same operator product.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax.ops.interp import CornerStream, InterpWeights, build_corner_stream

__all__ = [
    "DEVICE_BUILD_MIN",
    "WtWStencil",
    "build_wtw_stencil",
    "make_wtw_stencil_op",
    "wtw_stencil_bm",
]


DEVICE_BUILD_MIN = 1 << 25
"""Corner-pair updates (pairs × n) from which the tables are built on the
device instead of by the host ``bincount`` loop."""


class WtWStencil(NamedTuple):
    """Static stencil form of ``WᵀW`` (host-built, geometry-only).

    ``tables (D, M)``: coefficient rows, one per flat-index offset;
    ``deltas (D,)`` static ascending flat shifts; ``shape`` the grid shape.
    """

    tables: jax.Array
    deltas: Tuple[int, ...]
    shape: Tuple[int, ...]

    @property
    def M(self) -> int:
        return math.prod(self.shape)


def build_wtw_stencil(
    iw: InterpWeights,
    stream: CornerStream | None = None,
    *,
    dtype=None,
    max_table_bytes: int = 1 << 31,
) -> WtWStencil | None:
    """Stencil build: host numpy with f64 accumulation, or — past
    :data:`DEVICE_BUILD_MIN` corner-pair updates — one jitted device
    program with f32 accumulation (:func:`_build_tables_device`).

    Returns ``None`` when the table memory ``D·M·itemsize`` would exceed
    ``max_table_bytes`` or the pair enumeration ``4^d`` is unreasonable
    (d > 6) — callers keep the windowed/ELL point-space applies then.
    Pass ``stream`` to share the model's :class:`CornerStream`.
    """
    d = len(iw.shape)
    if 4**d > 4096:  # d > 6: table count and build cost both explode
        return None
    st = stream if stream is not None else build_corner_stream(iw)
    M = math.prod(st.shape)
    consts = np.asarray(st.consts, np.int64)
    base_sorted = np.asarray(st.base_sorted, np.int64)
    w_sorted = np.asarray(st.w_pts_sorted)
    nc = consts.shape[0]
    if dtype is None:
        dtype = w_sorted.dtype
    # Distinct offsets bound: ≤ 3^(non-degenerate dims).  Capacity gate
    # before doing any O(4^d · n) work.
    d_eff = sum(1 for m in iw.shape if m >= 2)
    D_bound = 3**d_eff
    if D_bound * M * np.dtype(dtype).itemsize > max_table_bytes:
        return None

    nonzero_k = [bool(np.any(w_sorted[k])) for k in range(nc)]

    # Symmetry halves the accumulation: (WᵀW)ᵀ = WᵀW ⟹
    # A_{-δ}[c] = (WᵀW)[c, c−δ] = A_δ[c−δ] — every negative-offset table is
    # a zero-filled flat right-shift of its positive sibling, so only pairs
    # with δ = consts[kp] − consts[k] ≥ 0 are accumulated directly.
    pairs = [
        (k, kp, int(consts[kp] - consts[k]))
        for k in range(nc)
        if nonzero_k[k]
        for kp in range(nc)
        if nonzero_k[kp] and consts[kp] >= consts[k]
    ]
    deltas_pos = sorted({delta for _, _, delta in pairs})

    if pairs and len(pairs) * w_sorted.shape[1] >= DEVICE_BUILD_MIN:
        # Device build: ONE jitted fori_loop of per-pair n-element
        # scatter-adds, where the host bincount loop takes minutes at
        # n=1M/32⁴.  Data-sized operands ride as program ARGUMENTS
        # (closure-capture rule, utils/closure.py); the tables never leave
        # the device.  Atomic scatter-adds sum in a run-dependent order, so
        # tables differ from the host build in the last f32 bits.
        cand = sorted({s * dl for dl in deltas_pos for s in (1, -1)})
        tables, keep = _build_tables_device(
            base_sorted, w_sorted, consts, pairs, deltas_pos, cand, M, dtype
        )
        keep = np.asarray(keep)
        deltas = [dl for dl, kp_ in zip(cand, keep) if kp_]
        if not deltas:
            deltas = [0]
            tables = jnp.zeros((1, M), dtype)
        else:
            tables = tables[np.flatnonzero(keep)]
        return WtWStencil(
            tables=tables, deltas=tuple(deltas), shape=tuple(st.shape)
        )

    acc: dict[int, np.ndarray] = {}
    for k, kp, delta in pairs:
        wprod = (w_sorted[k] * w_sorted[kp]).astype(np.float64)
        if not np.any(wprod):
            continue
        tab = np.bincount(base_sorted + consts[k], weights=wprod, minlength=M)
        if delta in acc:
            acc[delta] += tab
        else:
            acc[delta] = tab
    for delta in list(acc):
        if delta > 0:
            acc[-delta] = np.concatenate(
                [np.zeros(delta), acc[delta][: M - delta]]
            )
    deltas = sorted(dl for dl, tab in acc.items() if np.any(tab))
    if not deltas:  # n == 0 degenerate
        deltas = [0]
        acc[0] = np.zeros(M)
    tables = np.stack([acc[dl] for dl in deltas]).astype(dtype)
    return WtWStencil(
        tables=jnp.asarray(tables),
        deltas=tuple(int(dl) for dl in deltas),
        shape=tuple(st.shape),
    )


def _build_tables_device(
    base_sorted, w_sorted, consts, pairs, deltas_pos, cand, M, dtype
):
    """Whole table build as ONE jitted device program (eager per-delta ops
    would each dispatch and compile separately): δ ≥ 0 scatter-add
    accumulation into a flat
    ``(D⁺·M,)`` buffer, negative rows derived by the symmetry shift, plus
    the per-row keep mask.  f32 accumulation (per-cell contribution counts
    are ~n/M·2^d — far below f32's ~2^24 integer grain, and the operator
    feeds f32 CG anyway)."""
    row_of = {dl: i for i, dl in enumerate(deltas_pos)}
    k_idx = jnp.asarray([k for k, _, _ in pairs], jnp.int32)
    kp_idx = jnp.asarray([kp for _, kp, _ in pairs], jnp.int32)
    offset = jnp.asarray(
        [row_of[delta] * M + int(consts[k]) for k, _, delta in pairs],
        jnp.int32,
    )
    P, D = len(pairs), len(deltas_pos)

    def build(base, w):
        def body(p, out):
            wprod = w[k_idx[p]] * w[kp_idx[p]]
            return out.at[base + offset[p]].add(wprod)

        pos = jax.lax.fori_loop(
            0, P, body, jnp.zeros((D * M,), w.dtype)
        ).reshape(D, M)
        rows = []
        for dl in cand:
            if dl >= 0:
                rows.append(pos[row_of[dl]])
            else:  # A_{-δ}[c] = A_δ[c − δ]: zero-filled flat right-shift
                rows.append(
                    jnp.concatenate(
                        [jnp.zeros((-dl,), pos.dtype), pos[row_of[-dl], : M + dl]]
                    )
                )
        tables = jnp.stack(rows).astype(dtype)
        return tables, jnp.any(tables != 0, axis=1)

    return jax.jit(build)(
        jnp.asarray(base_sorted, jnp.int32),
        jnp.asarray(w_sorted, jnp.float32),
    )


# --------------------------------------------------------------------------
# Apply
# --------------------------------------------------------------------------


def _apply_xla(statics, tables, v_bm):
    """Pad + D static shifted multiply-adds: one loop fusion that reads the
    ``(D, M)`` tables and the padded ``v`` once each."""
    deltas, shape = statics
    M = math.prod(shape)
    S = max(1, max(abs(dl) for dl in deltas))
    vp = jnp.pad(v_bm, ((0, 0), (S, S)))
    out = jnp.zeros_like(v_bm)
    for i, dl in enumerate(deltas):
        out = out + tables[i][None, :] * jax.lax.slice_in_dim(
            vp, S + dl, S + dl + M, axis=1
        )
    return out


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _wtw_p(statics, arrays, v_bm):
    return _apply_xla(statics, arrays[0], v_bm)


def _wtw_fwd(statics, arrays, v_bm):
    return _apply_xla(statics, arrays[0], v_bm), arrays


def _wtw_bwd(statics, arrays, ct):
    # WᵀW is symmetric: the VJP in v is the same stencil on the cotangent.
    # Table cotangents are structurally required but unused in training
    # (geometry-only): zeros, DCE'd by XLA when not requested.
    zeros = tuple(jnp.zeros_like(a) for a in arrays)
    return (zeros, _apply_xla(statics, arrays[0], ct))


_wtw_p.defvjp(_wtw_fwd, _wtw_bwd)


def wtw_stencil_bm(st: WtWStencil, v_bm: jax.Array) -> jax.Array:
    """Apply ``WᵀW`` to batch-major lattice vectors: ``(B, M) → (B, M)``.

    Differentiable (self-adjoint custom VJP).
    """
    return _wtw_p((st.deltas, st.shape), (st.tables,), v_bm)


def make_wtw_stencil_op(st: WtWStencil):
    """Closure form of :func:`wtw_stencil_bm` for solver plumbing; the table
    array rides as a custom-VJP operand (hoistable by
    :func:`gp_grief_jax.utils.closure.explicit_closure`)."""

    def wtw(v_bm):
        return wtw_stencil_bm(st, v_bm)

    return wtw
