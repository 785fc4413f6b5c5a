"""Windowed (small-source) interpolation applies for the n ≳ m regime.

At n = 1M on a 32⁴ lattice, the exact ELL slot-gather ``Wᵀ``
(:func:`gp_grief_jax.ops.interp.interp_rmatvec_bm_exact`) and the fused
corner gather ``W`` both read from (B, ~1M) f32 sources (≥16 MB at B=4),
with random access across the whole source.  The windowed plan keeps each
gather's source small and local by making every gather source a
contiguous ``dynamic_slice``:

* points are **sorted by their base lattice cell** once on host (``perm``);
* ``Wᵀ``: a ``lax.scan`` over lattice-cell blocks of ``Cb`` cells — a
  block's contributing points lie in a contiguous sorted-point range of at
  most ``(Cb + Σ_d stride_d)·density`` (a corner's flat index exceeds its
  point's base cell by at most ``smax = Σ_d stride_d``), so each iteration
  slices a (B, Wr) window and gathers window-LOCAL ELL slots from it;
* ``W``: a scan over sorted-point blocks of ``P`` points — a block's 2^d
  corner cells lie in a contiguous lattice range of width ``≤ P·spread +
  smax``, so each iteration slices a (B, Wc) lattice window.

Inside the lattice-dual SKI operator the hot composition is ``Wᵀ(W(v))``
(:meth:`gp_grief_jax.models.gp_ski.GPSKIRegression._make_lattice_ops`):
both directions use the SAME sorted point order, so the permutation
cancels in the hot loop and only the solve *boundaries* (Wᵀy, the final
α/prediction maps) pay one (B, n) permutation gather each.

Both applies carry ``jax.custom_vjp`` whose backward is the opposite
direction (``W`` and ``Wᵀ`` are adjoint linear maps with constant
coefficients) — autodiff through the raw gathers would otherwise emit
colliding scatter-adds in every backward pass.

Reference parity note: this implements the same sparse Khatri-Rao ``W``
as the reference's SelectionMatrixSparse/KhatriRaoMatrix composition
(SURVEY.md §2 #2/#4); the windowing is a memory-locality redesign.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gp_grief_jax.ops.interp import InterpWeights

__all__ = [
    "WindowedPlan",
    "build_windowed_plan",
    "windowed_matvec_bm_sorted",
    "windowed_rmatvec_bm_sorted",
    "windowed_matvec_bm",
    "windowed_rmatvec_bm",
]


class WindowedPlan(NamedTuple):
    """Static per-model windowed-interpolation tables (host-built).

    Point order: ``perm (n,)`` sorts points by base cell; ``inv_perm``
    undoes it (``u_sorted = u[:, perm]``, ``u = u_sorted[:, inv_perm]``).

    ``Wᵀ`` (lattice blocks): ``wt_starts (T,)`` sorted-point window starts;
    ``wt_loc/wt_w (T, Cb, K)`` window-local ELL slots (w=0 padding);
    ``ov_ids/ov_src/ov_w`` exact overflow stream (cells with >K
    contributions; ``ov_src`` in sorted order).

    ``W`` (point blocks): ``w_starts (Tp,)`` lattice window starts;
    ``w_loc/w_w (Tp, P, 2^d)`` window-local corner indices and weights for
    each sorted point (w=0 padding past n).

    Static ints: window widths ``Wr/Wc``, block sizes ``Cb/P``, counts
    ``T/Tp``, and ``M/n``.
    """

    perm: jax.Array
    inv_perm: jax.Array
    wt_starts: jax.Array
    wt_loc: jax.Array
    wt_w: jax.Array
    ov_ids: jax.Array
    ov_src: jax.Array
    ov_w: jax.Array
    w_starts: jax.Array
    w_loc: jax.Array
    w_w: jax.Array
    Wr: int
    Cb: int
    T: int
    Wc: int
    P: int
    Tp: int
    M: int
    n: int


_GATHER_IDX_BUDGET = 163_840
"""Per-program-iteration gather-size budget (indices): blocks are sized so
``block · fan-in ≤ budget``.  The value was tuned for the previous
accelerator's gather; on the GPU it is untuned (ROADMAP 3b)."""


def build_windowed_plan(
    iw: InterpWeights,
    cell_block: int = 8192,
    point_block: int = 8192,
    max_slots: int = 64,
    window_limit: int = 1 << 18,
    force_slots: int | None = None,
    force_wr: int | None = None,
    force_wc: int | None = None,
    stream=None,
) -> WindowedPlan | None:
    """Host-side (numpy) windowed-plan construction; run once per model.

    ``cell_block``/``point_block`` are CAPS: actual block sizes are halved
    until ``Cb·K`` / ``P·2^d`` fit :data:`_GATHER_IDX_BUDGET` (the XLA
    gather-size cliff).  Returns ``None`` when a window would exceed
    ``window_limit`` (severely clustered data: a cell block's
    contributing-point range, or a point block's corner-cell range, does
    not stay bounded) — callers fall back to the flat ELL plan.

    ``force_slots``/``force_wr``/``force_wc`` override the derived ELL
    width / window widths (must be ≥ the derived values; widths are
    clamped to the axis lengths).  Used by the sharded builder to give
    every shard's plan identical static shapes for ``shard_map`` stacking.

    ``stream`` (a :func:`~gp_grief_jax.ops.interp.build_corner_stream`
    result) shares the corner-update stream with the other plan builders;
    the point sort, per-cell ranks, and ELL-width curve all come from it.
    """
    from gp_grief_jax.ops.interp import build_corner_stream

    d = len(iw.shape)
    M = math.prod(iw.shape)
    st = stream if stream is not None else build_corner_stream(iw)
    n = int(st.base.shape[0])
    strides = np.ones(d, dtype=np.int64)
    for dd in range(d - 2, -1, -1):
        strides[dd] = strides[dd + 1] * iw.shape[dd + 1]
    smax = int(strides.sum())

    perm = st.perm.astype(np.int64)
    inv_perm = st.inv_perm.astype(np.int64)
    base_sorted = st.base_sorted.astype(np.int64)

    # ---- Wᵀ: ELL over lattice-cell blocks, window-local sources ----------
    # Stream entries carry SORTED-point ids and per-cell ranks already.
    flat_s = st.flat_u.astype(np.int64)
    w_s = st.w_u
    src_s = st.src_u.astype(np.int64)
    rank = st.rank_u
    max_rank = len(st.tail)
    tail = st.tail
    K = 1
    # Same break-even rule as build_interp_plan: one more ELL column costs a
    # B·M-element gather, an overflow entry a serialized scatter (~22×).
    while K < min(max_rank, max_slots) and int(tail[K - 1]) > M // 22:
        K += 1
    if force_slots is not None:
        if force_slots < K:
            raise ValueError(f"force_slots={force_slots} < derived K={K}")
        K = int(force_slots)

    # Block size: capped, then halved until the per-iteration gather
    # (Cb·K indices) stays under the XLA gather-size cliff.
    Cb = int(min(cell_block, M))
    while Cb > 512 and Cb * K > _GATHER_IDX_BUDGET:
        Cb //= 2
    T = -(-M // Cb)

    # Window per cell block: contributing points have base in
    # [c0 - smax, c0 + Cb) → a contiguous sorted range.
    c0s = np.arange(T, dtype=np.int64) * Cb
    lo = np.searchsorted(base_sorted, c0s - smax, side="left")
    hi = np.searchsorted(base_sorted, c0s + Cb - 1, side="right")
    need = int((hi - lo).max()) if T else 1
    Wr = min(n, -(-max(need, 1) // 512) * 512)
    if force_wr is not None:
        if force_wr < Wr and force_wr < n:
            raise ValueError(f"force_wr={force_wr} < derived Wr={Wr}")
        Wr = min(n, int(force_wr))
    if Wr > window_limit:
        return None
    wt_starts = np.minimum(lo, n - Wr).astype(np.int64)
    wt_starts = np.maximum(wt_starts, 0)

    in_slot = rank < K
    tile = flat_s // Cb
    local_src = src_s - wt_starts[tile]
    # In-slot entries must land inside their block's window; guaranteed by
    # construction (assert cheaply for the clamped edge blocks).
    ok = (local_src >= 0) & (local_src < Wr)
    if not bool(np.all(ok[in_slot])):  # pragma: no cover - construction bug
        raise AssertionError("windowed plan: slot source outside its window")
    cell_local = flat_s - tile * Cb
    wt_loc = np.zeros((T, Cb, K), np.int64)
    wt_w = np.zeros((T, Cb, K), w_s.dtype)
    wt_loc[tile[in_slot], cell_local[in_slot], rank[in_slot]] = local_src[in_slot]
    wt_w[tile[in_slot], cell_local[in_slot], rank[in_slot]] = w_s[in_slot]
    ov = ~in_slot

    # ---- W: corner gathers over sorted-point blocks ----------------------
    P = int(min(point_block, n))
    while P > 512 and P * (2 ** d) > _GATHER_IDX_BUDGET:
        P //= 2
    Tp = -(-n // P)
    n_pad = Tp * P
    # (2^d, n) flat corner ids / weights over sorted points: corner flat is
    # exactly base + consts[k] (see CornerStream).
    corner_sorted = base_sorted[None, :] + st.consts[:, None].astype(np.int64)
    w_sorted_pts = st.w_pts_sorted
    p0s = np.arange(Tp, dtype=np.int64) * P
    p1s = np.minimum(p0s + P, n)
    blk_lo = base_sorted[p0s]
    blk_hi = base_sorted[p1s - 1] + smax  # inclusive upper corner bound
    needc = int((blk_hi - (blk_lo // 128) * 128 + 1).max()) if Tp else 1
    Wc = min(M, -(-max(needc, 1) // 512) * 512)
    if force_wc is not None:
        if force_wc < Wc and force_wc < M:
            raise ValueError(f"force_wc={force_wc} < derived Wc={Wc}")
        Wc = min(M, int(force_wc))
    if Wc > window_limit:
        return None
    w_starts = np.minimum((blk_lo // 128) * 128, M - Wc)
    w_starts = np.maximum(w_starts, 0)
    w_loc = np.zeros((Tp, P, 2 ** d), np.int64)
    w_w = np.zeros((Tp, P, 2 ** d), w_s.dtype)
    for b in range(Tp):
        sl = slice(p0s[b], p1s[b])
        cnt = p1s[b] - p0s[b]
        w_loc[b, :cnt] = (corner_sorted[:, sl] - w_starts[b]).T
        w_w[b, :cnt] = w_sorted_pts[:, sl].T
    if not bool(np.all((w_loc >= 0) & (w_loc < Wc))):  # pragma: no cover
        raise AssertionError("windowed plan: corner outside its window")

    return WindowedPlan(
        perm=jnp.asarray(perm, jnp.int32),
        inv_perm=jnp.asarray(inv_perm, jnp.int32),
        wt_starts=jnp.asarray(wt_starts, jnp.int32),
        wt_loc=jnp.asarray(wt_loc, jnp.int32),
        wt_w=jnp.asarray(wt_w),
        ov_ids=jnp.asarray(flat_s[ov], jnp.int32),
        ov_src=jnp.asarray(src_s[ov], jnp.int32),
        ov_w=jnp.asarray(w_s[ov]),
        w_starts=jnp.asarray(w_starts, jnp.int32),
        w_loc=jnp.asarray(w_loc, jnp.int32),
        w_w=jnp.asarray(w_w),
        Wr=int(Wr), Cb=Cb, T=int(T), Wc=int(Wc), P=P, Tp=int(Tp),
        M=int(M), n=n,
    )


def _pad_b1(fn, plan, v):
    """Run a windowed apply at B=2 when called with B=1: single-row scans
    lowered to a degenerate, several-times-slower form on the previous
    accelerator, and the extra zero row is cheap (untuned on the GPU)."""
    out = fn(plan, jnp.concatenate([v, jnp.zeros_like(v)], axis=0))
    return out[:1]


def _rmatvec_impl(plan: WindowedPlan, u_sorted: jax.Array) -> jax.Array:
    """``Wᵀ u``: ``(B, n)`` sorted-point order → ``(B, M)``."""
    if u_sorted.shape[0] == 1:
        return _pad_b1(_rmatvec_impl, plan, u_sorted)
    B = u_sorted.shape[0]
    Cb, K, Wr, T, M = plan.Cb, plan.wt_loc.shape[-1], plan.Wr, plan.T, plan.M

    def body(_, inp):
        s, lc, w = inp
        win = lax.dynamic_slice(u_sorted, (jnp.zeros((), s.dtype), s), (B, Wr))
        g = win[:, lc.reshape(-1)].reshape(B, Cb, K)
        return _, jnp.sum(w[None] * g, axis=-1)  # (B, Cb)

    _, blocks = lax.scan(body, 0, (plan.wt_starts, plan.wt_loc, plan.wt_w))
    out = jnp.moveaxis(blocks, 1, 0).reshape(B, T * Cb)[:, :M]
    if int(plan.ov_ids.shape[0]) > 0:
        # Elementwise (VPU) sums, exact f32 — same reordered short sums as
        # the scatter-add; the overflow stream is tiny by construction.
        out = out.at[:, plan.ov_ids].add(plan.ov_w[None, :] * u_sorted[:, plan.ov_src])
    return out


def _matvec_impl(plan: WindowedPlan, v_lat: jax.Array) -> jax.Array:
    """``W v``: ``(B, M)`` lattice → ``(B, n)`` sorted-point order."""
    if v_lat.shape[0] == 1:
        return _pad_b1(_matvec_impl, plan, v_lat)
    B = v_lat.shape[0]
    P, C2, Wc, Tp, n = plan.P, plan.w_loc.shape[-1], plan.Wc, plan.Tp, plan.n

    def body(_, inp):
        s, lc, w = inp
        win = lax.dynamic_slice(v_lat, (jnp.zeros((), s.dtype), s), (B, Wc))
        g = win[:, lc.reshape(-1)].reshape(B, P, C2)
        return _, jnp.sum(w[None] * g, axis=-1)  # (B, P)

    _, blocks = lax.scan(body, 0, (plan.w_starts, plan.w_loc, plan.w_w))
    return jnp.moveaxis(blocks, 1, 0).reshape(B, Tp * P)[:, :n]


def _rmatvec_unrolled(plan: WindowedPlan, u_sorted: jax.Array) -> jax.Array:
    """Statically-unrolled ``Wᵀ u`` (python loop over blocks; window starts
    become compile-time constants → static ``lax.slice`` windows).  Debug /
    perf-comparison variant of :func:`_rmatvec_impl`."""
    B = u_sorted.shape[0]
    Cb, K, Wr, T, M = plan.Cb, plan.wt_loc.shape[-1], plan.Wr, plan.T, plan.M
    starts = np.asarray(plan.wt_starts)
    outs = []
    for b in range(T):
        s = int(starts[b])
        win = lax.slice(u_sorted, (0, s), (B, s + Wr))
        g = win[:, plan.wt_loc[b].reshape(-1)].reshape(B, Cb, K)
        outs.append(jnp.sum(plan.wt_w[b][None] * g, axis=-1))
    out = jnp.concatenate(outs, axis=1)[:, :M]
    if int(plan.ov_ids.shape[0]) > 0:
        out = out.at[:, plan.ov_ids].add(plan.ov_w[None, :] * u_sorted[:, plan.ov_src])
    return out


def _matvec_unrolled(plan: WindowedPlan, v_lat: jax.Array) -> jax.Array:
    """Statically-unrolled ``W v`` — see :func:`_rmatvec_unrolled`."""
    B = v_lat.shape[0]
    P, C2, Wc, Tp, n = plan.P, plan.w_loc.shape[-1], plan.Wc, plan.Tp, plan.n
    starts = np.asarray(plan.w_starts)
    outs = []
    for b in range(Tp):
        s = int(starts[b])
        win = lax.slice(v_lat, (0, s), (B, s + Wc))
        g = win[:, plan.w_loc[b].reshape(-1)].reshape(B, P, C2)
        outs.append(jnp.sum(plan.w_w[b][None] * g, axis=-1))
    return jnp.concatenate(outs, axis=1)[:, :n]


_ARRAY_FIELDS = (
    "perm", "inv_perm", "wt_starts", "wt_loc", "wt_w",
    "ov_ids", "ov_src", "ov_w", "w_starts", "w_loc", "w_w",
)
_STATIC_FIELDS = ("Wr", "Cb", "T", "Wc", "P", "Tp", "M", "n")


def plan_split(plan: WindowedPlan):
    """``(arrays, statics)`` — the plan's array fields as a tuple of
    operands and its static ints as a hashable tuple."""
    return (
        tuple(getattr(plan, f) for f in _ARRAY_FIELDS),
        tuple(int(getattr(plan, f)) for f in _STATIC_FIELDS),
    )


def plan_join(statics, arrays) -> WindowedPlan:
    """Inverse of :func:`plan_split`."""
    kw = dict(zip(_ARRAY_FIELDS, arrays))
    kw.update(dict(zip(_STATIC_FIELDS, statics)))
    return WindowedPlan(**kw)


def _zero_cts(arrays):
    """Cotangents for the (constant) plan operands: float0 for integer
    tables, zeros for float ones — never consumed (gradients are only
    requested w.r.t. solver/parameter inputs), so XLA DCEs them."""
    out = []
    for a in arrays:
        if jnp.issubdtype(a.dtype, jnp.floating):
            out.append(jnp.zeros_like(a))
        else:
            out.append(np.zeros(a.shape, dtype=jax.dtypes.float0))
    return tuple(out)


# custom_vjp pair with the plan ARRAYS as explicit arguments and statics as
# nondiff hashables.  Two reasons over closure-captured plans: (1) the
# adjoint of each direction is the other direction, so backward passes
# never emit colliding scatter-adds; (2) closure capture embeds the
# ~100s-of-MB tables as LITERALS when the backward is lowered (value-only
# programs hoist fine via explicit_closure, but the bwd jaxpr's consts of a
# captured-plan custom_vjp are not hoistable).
def _rmv_p(statics, arrays, u_sorted):
    return _rmatvec_impl(plan_join(statics, arrays), u_sorted)


def _rmv_fwd(statics, arrays, u_sorted):
    return _rmv_p(statics, arrays, u_sorted), arrays


def _rmv_bwd(statics, arrays, ct):
    return _zero_cts(arrays), _matvec_impl(plan_join(statics, arrays), ct)


rmatvec_sorted_p = jax.custom_vjp(_rmv_p, nondiff_argnums=(0,))
rmatvec_sorted_p.defvjp(_rmv_fwd, _rmv_bwd)


def _mv_p(statics, arrays, v_lat):
    return _matvec_impl(plan_join(statics, arrays), v_lat)


def _mv_fwd(statics, arrays, v_lat):
    return _mv_p(statics, arrays, v_lat), arrays


def _mv_bwd(statics, arrays, ct):
    return _zero_cts(arrays), _rmatvec_impl(plan_join(statics, arrays), ct)


matvec_sorted_p = jax.custom_vjp(_mv_p, nondiff_argnums=(0,))
matvec_sorted_p.defvjp(_mv_fwd, _mv_bwd)


def make_windowed_ops(plan: WindowedPlan):
    """Differentiable ``(matvec_sorted, rmatvec_sorted)`` callables.

    ``matvec_sorted(v (B, M)) → (B, n)`` and ``rmatvec_sorted(u (B, n)) →
    (B, M)`` in the plan's SORTED point order, backed by the
    argument-passing custom-VJP pair (:func:`matvec_sorted_p` /
    :func:`rmatvec_sorted_p`) — adjoints route through the sibling
    direction (no scatter in backward), and the plan tables flow as
    operands (no literal embedding when gradients are lowered).  Any
    jitted program using these at n ≳ 100k must still hoist the captured
    table arrays via ``utils.closure.explicit_closure`` (CLAUDE.md
    closure-capture rule) — the model paths do.
    """
    arrays, statics = plan_split(plan)

    def matvec_sorted(v_lat):
        return matvec_sorted_p(statics, arrays, v_lat)

    def rmatvec_sorted(u_sorted):
        return rmatvec_sorted_p(statics, arrays, u_sorted)

    return matvec_sorted, rmatvec_sorted


def windowed_rmatvec_bm_sorted(plan: WindowedPlan, u_sorted: jax.Array) -> jax.Array:
    """One-shot exact ``Wᵀ u`` (sorted-point input) — prefer
    :func:`make_windowed_ops` in model code (stable jit-cache identity,
    custom VJP)."""
    return _rmatvec_impl(plan, u_sorted)


def windowed_matvec_bm_sorted(plan: WindowedPlan, v_lat: jax.Array) -> jax.Array:
    """One-shot exact ``W v`` (sorted-point output) — prefer
    :func:`make_windowed_ops` in model code."""
    return _matvec_impl(plan, v_lat)


def windowed_rmatvec_bm(plan: WindowedPlan, u_bm: jax.Array) -> jax.Array:
    """``Wᵀ u`` from DATA-order ``(B, n)`` input (one permutation gather)."""
    return _rmatvec_impl(plan, u_bm[:, plan.perm])


def windowed_matvec_bm(plan: WindowedPlan, v_lat: jax.Array) -> jax.Array:
    """``W v`` to DATA-order ``(B, n)`` output (one permutation gather)."""
    return _matvec_impl(plan, v_lat)[:, plan.inv_perm]
