"""Grid interpolation operators (SKI-style sparse Khatri-Rao weights).

BASELINE config 2 names "SKI-style interpolation weights": scattered points
are tied to a Cartesian grid by a sparse interpolation matrix ``W`` whose row
``i`` factorizes over dimensions, ``W[i] = ⊗_d w_d(x_i)``, with each ``w_d``
having two non-zeros (linear interpolation between the bracketing grid
points).  In the reference's vocabulary this is a row-partitioned Khatri-Rao
product of per-dimension *sparse* factors (``SelectionMatrixSparse`` +
``KhatriRaoMatrix`` — SURVEY.md §2 #2/#4); here it is index arrays +
gathers/scatters, ``O(n · 2^d)`` per product with no sparse-matrix machinery.

``W @ v_grid`` interpolates grid values to the points; ``Wᵀ @ u`` spreads
point mass onto grid corners.  Combined with the Kronecker Gram this gives the
SKI kernel ``k̂(x, z) = W_x (⊗K_d) W_zᵀ`` whose matvec is
gather → Kron-matvec → scatter, all structured.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "InterpWeights",
    "InterpPlan",
    "CornerStream",
    "interp_weights",
    "build_corner_stream",
    "build_interp_plan",
    "interp_matvec",
    "interp_rmatvec",
    "interp_matvec_bm",
    "interp_rmatvec_bm",
    "interp_matvec_bm_fast",
    "interp_rmatvec_bm_fast",
    "interp_rmatvec_bm_exact",
    "interp_expand",
]


class InterpWeights(NamedTuple):
    """Per-dimension linear-interpolation data for ``n`` points on a grid.

    ``idx[d]``: ``(n,)`` int32 — left bracketing grid index in dim ``d``;
    ``w[d]``: ``(n, 2)`` — weights of (left, right) grid points;
    ``shape``: the grid shape ``(m_1, ..., m_d)``.
    """

    idx: Tuple[jax.Array, ...]
    w: Tuple[jax.Array, ...]
    shape: Tuple[int, ...]


def interp_weights(x: jax.Array, xg: Sequence[jax.Array]) -> InterpWeights:
    """Linear interpolation weights of points ``x`` (n, d) on grid ``xg``.

    Points outside the grid clamp to the boundary cell (constant
    extrapolation of the cell's linear model).  Jittable: ``searchsorted`` +
    arithmetic only.  CONCRETE inputs take a host-numpy fast path: run
    eagerly, the ~8 jax ops per dimension would each dispatch as a separate
    device program, and every consumer of an eager build is a host-side
    plan builder anyway (:func:`build_corner_stream`).
    """
    if not any(
        isinstance(a, jax.core.Tracer) for a in (x, *xg)
    ):
        return _interp_weights_np(x, xg)
    if x.ndim == 1:
        x = x[:, None]
    idxs, ws = [], []
    for d, g in enumerate(xg):
        gd = g.reshape(-1)
        m = gd.shape[0]
        xi = x[:, d]
        if m == 1:
            # Degenerate dimension (e.g. a constant feature column): all mass
            # on the single grid point.
            idxs.append(jnp.zeros(xi.shape, jnp.int32))
            ws.append(
                jnp.stack([jnp.ones_like(xi), jnp.zeros_like(xi)], axis=1).astype(x.dtype)
            )
            continue
        left = jnp.clip(jnp.searchsorted(gd, xi, side="right") - 1, 0, m - 2)
        g0 = gd[left]
        g1 = gd[left + 1]
        span = g1 - g0
        t = jnp.clip((xi - g0) / jnp.where(span > 0, span, 1.0), 0.0, 1.0)
        idxs.append(left.astype(jnp.int32))
        ws.append(jnp.stack([1.0 - t, t], axis=1).astype(x.dtype))
    return InterpWeights(
        idx=tuple(idxs), w=tuple(ws), shape=tuple(int(g.shape[0]) for g in xg)
    )


def _interp_weights_np(x, xg) -> InterpWeights:
    """Host-numpy :func:`interp_weights` (same math, same clamping)."""
    import numpy as np

    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    idxs, ws = [], []
    for d, g in enumerate(xg):
        gd = np.asarray(g).reshape(-1)
        m = gd.shape[0]
        xi = x[:, d]
        if m == 1:
            idxs.append(np.zeros(xi.shape, np.int32))
            ws.append(
                np.stack([np.ones_like(xi), np.zeros_like(xi)], axis=1).astype(x.dtype)
            )
            continue
        left = np.clip(np.searchsorted(gd, xi, side="right") - 1, 0, m - 2)
        g0 = gd[left]
        g1 = gd[left + 1]
        span = g1 - g0
        t = np.clip((xi - g0) / np.where(span > 0, span, 1.0), 0.0, 1.0)
        idxs.append(left.astype(np.int32))
        ws.append(np.stack([1.0 - t, t], axis=1).astype(x.dtype))
    return InterpWeights(
        idx=tuple(idxs), w=tuple(ws), shape=tuple(int(g.shape[0]) for g in xg)
    )


def _corner_flat_idx(iw: InterpWeights, offsets) -> jax.Array:
    """Flat C-order grid index of one corner combination (n,).

    Corner indices clip to the dimension bound so phantom corners of
    degenerate (m_d = 1) dimensions — whose weight is exactly zero — cannot
    bleed into neighbouring flat indices.
    """
    flat = None
    for d, (left, off) in enumerate(zip(iw.idx, offsets)):
        comp = jnp.minimum(left + off, iw.shape[d] - 1)
        flat = comp if flat is None else flat * iw.shape[d] + comp
    return flat


def interp_matvec(iw: InterpWeights, v_grid: jax.Array) -> jax.Array:
    """``W @ v``: interpolate grid values to the points.  ``v``: ``(M,)`` or
    ``(M, B)``; output ``(n,)`` / ``(n, B)``.  O(n·2^d) gathers."""
    d = len(iw.shape)
    squeeze = v_grid.ndim == 1
    vv = v_grid[:, None] if squeeze else v_grid
    out = None
    for offsets in itertools.product((0, 1), repeat=d):
        flat = _corner_flat_idx(iw, offsets)
        weight = None
        for dd, off in enumerate(offsets):
            wd = iw.w[dd][:, off]
            weight = wd if weight is None else weight * wd
        contrib = weight[:, None] * jnp.take(vv, flat, axis=0)
        out = contrib if out is None else out + contrib
    return out[:, 0] if squeeze else out


def interp_rmatvec(iw: InterpWeights, u: jax.Array) -> jax.Array:
    """``Wᵀ @ u``: scatter point values onto grid corners.  Output ``(M,)`` /
    ``(M, B)``."""
    d = len(iw.shape)
    M = math.prod(iw.shape)
    squeeze = u.ndim == 1
    uu = u[:, None] if squeeze else u
    out = jnp.zeros((M, uu.shape[1]), dtype=uu.dtype)
    for offsets in itertools.product((0, 1), repeat=d):
        flat = _corner_flat_idx(iw, offsets)
        weight = None
        for dd, off in enumerate(offsets):
            wd = iw.w[dd][:, off]
            weight = wd if weight is None else weight * wd
        out = out.at[flat].add(weight[:, None] * uu)
    return out[:, 0] if squeeze else out


def interp_matvec_bm(iw: InterpWeights, v_grid_bm: jax.Array) -> jax.Array:
    """Batch-major ``W @ v``: ``v`` is ``(B, M)``, output ``(B, n)``.

    Batch-major keeps the long axis contiguous: every solver in the
    package carries its state as ``(B, m)`` rows."""
    d = len(iw.shape)
    out = None
    for offsets in itertools.product((0, 1), repeat=d):
        flat = _corner_flat_idx(iw, offsets)
        weight = None
        for dd, off in enumerate(offsets):
            wd = iw.w[dd][:, off]
            weight = wd if weight is None else weight * wd
        contrib = weight[None, :] * v_grid_bm[:, flat]
        out = contrib if out is None else out + contrib
    return out


def interp_rmatvec_bm(iw: InterpWeights, u_bm: jax.Array) -> jax.Array:
    """Batch-major ``Wᵀ @ u``: ``u`` is ``(B, n)``, output ``(B, M)`` —
    see :func:`interp_matvec_bm` for why batch-major matters at large M."""
    d = len(iw.shape)
    M = math.prod(iw.shape)
    out = jnp.zeros((u_bm.shape[0], M), dtype=u_bm.dtype)
    for offsets in itertools.product((0, 1), repeat=d):
        flat = _corner_flat_idx(iw, offsets)
        weight = None
        for dd, off in enumerate(offsets):
            wd = iw.w[dd][:, off]
            weight = wd if weight is None else weight * wd
        out = out.at[:, flat].add(weight[None, :] * u_bm)
    return out


class CornerStream(NamedTuple):
    """Shared host-side (numpy) corner-update stream; built once per model.

    Every interpolation plan (flat ELL :class:`InterpPlan`, windowed
    :class:`~gp_grief_jax.ops.interp_windowed.WindowedPlan`) starts from the
    same multiset of ``2^d·n`` (corner cell, weight, point) updates; building
    it independently per plan costs tens of seconds of host time at
    n=1M/32⁴ — most of it ``2^d·n``-element int64 argsorts.

    Two structural facts kill almost all of that work:

    * :func:`interp_weights` clamps ``left ≤ m_d − 2``, and degenerate
      ``m_d = 1`` dims contribute index 0 at weight 0 — so EVERY corner's
      flat index is exactly ``base + consts[k]`` (``base`` = the point's own
      cell; ``consts[k]`` a per-corner constant skipping degenerate dims).
      No per-corner index arithmetic, and after the one ``n``-element sort
      of ``base`` each corner's stream is ALREADY sorted by cell.
    * Per-cell ranks then follow from *counting* (within-corner rank via one
      segment scan shared by all unpruned corners, plus a running per-cell
      offset accumulated corner by corner) — never from a ``2^d·n`` argsort.
      A cell-major sorted stream, where a plan needs one, is a counting
      sort: ``position = cell_start[flat] + rank``.

    Fields (all host numpy; ``L = Σ_k nnz_k`` after zero-weight pruning):
    ``base (n,)`` int32 data-order base cells; ``consts (2^d,)`` int32;
    ``perm/inv_perm (n,)`` int32 cell-sort of the points and its inverse;
    ``base_sorted (n,)``; ``w_pts_sorted (2^d, n)`` per-corner weights in
    sorted-point order (unpruned — zero-weight entries kept for gather
    tables); ``flat_u/w_u/src_u/rank_u (L,)`` the pruned stream in
    corner-major order — flat cell, weight, SORTED-point id, and the
    entry's rank within its cell (a permutation of ``0..c−1`` per cell);
    ``counts (M,)`` per-cell totals; ``tail`` rank-tail histogram
    (``tail[k-1] = #(rank ≥ k)``, the ELL-width selection curve);
    ``shape`` the grid shape.
    """

    base: "object"
    consts: "object"
    perm: "object"
    inv_perm: "object"
    base_sorted: "object"
    w_pts_sorted: "object"
    flat_u: "object"
    w_u: "object"
    src_u: "object"
    rank_u: "object"
    counts: "object"
    tail: "object"
    shape: Tuple[int, ...]


def build_corner_stream(iw: InterpWeights) -> CornerStream:
    """Build the shared :class:`CornerStream` for an :class:`InterpWeights`.

    Host numpy, not jittable.  Pass the result
    to :func:`build_interp_plan` /
    :func:`~gp_grief_jax.ops.interp_windowed.build_windowed_plan` via their
    ``stream=`` argument to share it.
    """
    import numpy as np

    d = len(iw.shape)
    M = math.prod(iw.shape)
    n = int(np.asarray(iw.idx[0]).shape[0])
    idx_h = [np.asarray(ix).astype(np.int64) for ix in iw.idx]
    w_h = [np.asarray(w) for w in iw.w]
    strides = np.ones(d, np.int64)
    for dd in range(d - 2, -1, -1):
        strides[dd] = strides[dd + 1] * iw.shape[dd + 1]
    smax = int(strides.sum())
    base64 = np.zeros(n, np.int64)
    for dd in range(d):
        base64 += idx_h[dd] * strides[dd]
    base = base64.astype(np.int32)
    offs = list(itertools.product((0, 1), repeat=d))
    consts = np.asarray(
        [
            sum(int(o[dd]) * int(strides[dd]) for dd in range(d) if iw.shape[dd] >= 2)
            for o in offs
        ],
        np.int32,
    )
    perm = np.argsort(base, kind="stable").astype(np.int32)
    inv_perm = np.empty(n, np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)
    base_sorted = base[perm]
    ws_h = [w_h[dd][perm] for dd in range(d)]
    w_pts_sorted = np.empty((2**d, n), w_h[0].dtype)
    for k, o in enumerate(offs):
        w = ws_h[0][:, o[0]].copy()
        for dd in range(1, d):
            w *= ws_h[dd][:, o[dd]]
        w_pts_sorted[k] = w
    nz = w_pts_sorted != 0
    cnt_k = nz.sum(axis=1)
    L = int(cnt_k.sum())
    flat_u = np.empty(L, np.int32)
    w_u = np.empty(L, w_pts_sorted.dtype)
    src_u = np.empty(L, np.int32)
    rank_u = np.empty(L, np.int32)
    idxn = np.arange(n, dtype=np.int64)
    within0 = None
    if n:
        newseg0 = np.empty(n, bool)
        newseg0[0] = True
        np.not_equal(base_sorted[1:], base_sorted[:-1], out=newseg0[1:])
        within0 = idxn - np.maximum.accumulate(np.where(newseg0, idxn, 0))
    counts_base = np.bincount(base_sorted, minlength=M).astype(np.int64)
    ar = np.arange(n, dtype=np.int32)
    # Running per-cell offsets; +smax slack lets each unpruned corner update
    # by one shifted slice-add of counts_base instead of a fresh bincount.
    cum = np.zeros(M + smax + 1, np.int64)
    pos = 0
    for k in range(2**d):
        Lk = int(cnt_k[k])
        if Lk == 0:
            continue
        ck = int(consts[k])
        sl = slice(pos, pos + Lk)
        pos += Lk
        if Lk == n:
            # No pruned entries: this corner shares base's segment structure.
            np.add(base_sorted, np.int32(ck), out=flat_u[sl])
            w_u[sl] = w_pts_sorted[k]
            src_u[sl] = ar
            rank_u[sl] = cum[flat_u[sl]] + within0
            cum[ck : ck + M] += counts_base
        else:
            nzk = nz[k]
            f = base_sorted[nzk] + np.int32(ck)
            flat_u[sl] = f
            w_u[sl] = w_pts_sorted[k][nzk]
            src_u[sl] = ar[nzk]
            il = np.arange(Lk, dtype=np.int64)
            ns = np.empty(Lk, bool)
            ns[0] = True
            np.not_equal(f[1:], f[:-1], out=ns[1:])
            within = il - np.maximum.accumulate(np.where(ns, il, 0))
            rank_u[sl] = cum[f] + within
            cum[:M] += np.bincount(f, minlength=M)
    counts = cum[:M].copy()
    hist = np.bincount(rank_u) if L else np.zeros(1, np.int64)
    tail = L - np.cumsum(hist)
    return CornerStream(
        base=base,
        consts=consts,
        perm=perm,
        inv_perm=inv_perm,
        base_sorted=base_sorted,
        w_pts_sorted=w_pts_sorted,
        flat_u=flat_u,
        w_u=w_u,
        src_u=src_u,
        rank_u=rank_u,
        counts=counts,
        tail=tail,
        shape=tuple(iw.shape),
    )


class InterpPlan(NamedTuple):
    """Scatter-free interpolation plan (static per model; built once on host).

    The 2^d corner scatters of :func:`interp_rmatvec_bm` collide on shared
    cells (atomics on the GPU, run-to-run nondeterministic sums).  The plan
    re-expresses ``Wᵀ u`` with gathers only, in two flavors:

    **cumsum** (:func:`interp_rmatvec_bm_fast`): sort the ``2^d·n``
    (corner, point) update stream by flat grid index ONCE (host, numpy),
    then per application

        vals = w_sorted ⊙ u[:, src_col]          (one gather)
        cs0  = [0, cumsum(vals, axis=1)]
        out  = cs0[:, end_ptr] − cs0[:, start_ptr]   (two dense gathers)

    where ``start_ptr/end_ptr`` are per-grid-node segment pointers into the
    sorted stream (empty nodes point at equal positions → exact 0).  The
    f32 running sum leaves ~5e-5 rel error, which SLQ κ-amplifies to ~1%
    NLML error (unusable there).

    **slots** (:func:`interp_rmatvec_bm_exact`): ELL-format layout — node
    ``j`` gathers its ≤``K`` contributions from padded per-node slot tables
    ``slot_src/slot_w (M, K)`` (w=0 pads) and sums them in registers; the
    few nodes with >``K`` contributions route the excess through a tiny
    residual scatter (``ov_*``).  EXACT: the same short f32 sums the
    scatter-add does, just reordered.

    ``W u`` (forward) becomes one fused gather + an in-register weighted sum
    over the 2^d corners (``gather_flat/gather_w``) — exact, no per-corner
    dispatch.

    Fields: ``src_col (2^d·n,)`` point column per sorted update; ``w_sorted``
    matching weights; ``start_ptr/end_ptr (M,)``; ``gather_flat (2^d, n)`` /
    ``gather_w (2^d, n)``; ``slot_src/slot_w (M, K)``; ``ov_ids/ov_src/ov_w``
    overflow streams (possibly length 0); ``shape``.
    """

    src_col: jax.Array
    w_sorted: jax.Array
    start_ptr: jax.Array
    end_ptr: jax.Array
    gather_flat: jax.Array
    gather_w: jax.Array
    slot_src: jax.Array
    slot_w: jax.Array
    ov_ids: jax.Array
    ov_src: jax.Array
    ov_w: jax.Array
    shape: Tuple[int, ...]


def build_interp_plan(
    iw: InterpWeights, max_slots: int = 64, stream: CornerStream | None = None
) -> InterpPlan:
    """Host-side (numpy) preprocessing of an :class:`InterpWeights` into a
    scatter-free :class:`InterpPlan`.  Not jittable; run once at model
    construction.  Pass ``stream`` (a :func:`build_corner_stream` result) to
    share the corner-update stream with the other plan builders — all the
    heavy work lives there; this function is then pure counting-sort fills.

    ``max_slots`` caps the ELL width ``K``; the actual ``K`` is chosen by a
    gather-vs-scatter break-even rule (grow while the overflow stream
    exceeds ~M/22 entries), capped at ``max_slots`` — excess contributions
    go to the overflow scatter stream, exact either way.  The rule
    self-limits, so the cap only matters at n ≳ m where mean
    contributions/cell = 2^d·n/M exceed it."""
    import numpy as np

    st = stream if stream is not None else build_corner_stream(iw)
    M = math.prod(st.shape)
    L = int(st.flat_u.shape[0])
    # Cell-major sorted stream by counting sort: position = cell_start + rank.
    cell_bounds = np.zeros(M + 1, np.int64)
    np.cumsum(st.counts, out=cell_bounds[1:])
    pos = cell_bounds[st.flat_u] + st.rank_u
    src_data = st.perm[st.src_u].astype(np.int64)  # data-order point ids
    src = np.empty(L, np.int64)
    src[pos] = src_data
    w_sorted = np.empty(L, st.w_u.dtype)
    w_sorted[pos] = st.w_u
    # Segment pointers: empty cells get start == end → exact 0 contribution
    # in the cumsum form (the pre-stream builder parked them at 0/0; any
    # equal pair is equivalent).
    node_start = cell_bounds[:M]
    node_end = cell_bounds[1:]

    # ELL width: a slot column gathers B·M elements while an overflow
    # entry scatters B elements with collisions; one more column is taken
    # only while the overflow stream holds > M/22 entries.
    max_rank = len(st.tail)
    K = 1
    while K < min(max_rank, max_slots) and int(st.tail[K - 1]) > M // 22:
        K += 1
    in_slot = st.rank_u < K
    slot_src = np.zeros((M, K), dtype=np.int64)
    slot_w = np.zeros((M, K), dtype=st.w_u.dtype)
    slot_src[st.flat_u[in_slot], st.rank_u[in_slot]] = src_data[in_slot]
    slot_w[st.flat_u[in_slot], st.rank_u[in_slot]] = st.w_u[in_slot]
    ov = ~in_slot

    # Dense per-corner gather tables (data order, zero-weight corners kept):
    # flat = base + consts[k] exactly — see CornerStream.
    gather_flat = st.base[None, :].astype(np.int64) + st.consts[:, None]
    gather_w = st.w_pts_sorted[:, st.inv_perm]

    return InterpPlan(
        src_col=jnp.asarray(src, jnp.int32),
        w_sorted=jnp.asarray(w_sorted),
        start_ptr=jnp.asarray(node_start, jnp.int32),
        end_ptr=jnp.asarray(node_end, jnp.int32),
        gather_flat=jnp.asarray(gather_flat, jnp.int32),
        gather_w=jnp.asarray(gather_w),
        slot_src=jnp.asarray(slot_src, jnp.int32),
        slot_w=jnp.asarray(slot_w),
        ov_ids=jnp.asarray(st.flat_u[ov], jnp.int32),
        ov_src=jnp.asarray(src_data[ov], jnp.int32),
        ov_w=jnp.asarray(st.w_u[ov]),
        shape=tuple(st.shape),
    )


def interp_rmatvec_bm_fast(plan: InterpPlan, u_bm: jax.Array) -> jax.Array:
    """Scatter-free batch-major ``Wᵀ @ u``: ``(B, n) → (B, M)`` — see
    :class:`InterpPlan` (f32-cumsum accuracy ~5e-5 rel; inner-loop use)."""
    B = u_bm.shape[0]
    vals = plan.w_sorted[None, :] * u_bm[:, plan.src_col]
    cs0 = jnp.concatenate(
        [jnp.zeros((B, 1), u_bm.dtype), jnp.cumsum(vals, axis=1)], axis=1
    )
    return cs0[:, plan.end_ptr] - cs0[:, plan.start_ptr]


def interp_rmatvec_bm_exact(plan: InterpPlan, u_bm: jax.Array) -> jax.Array:
    """EXACT scatter-free batch-major ``Wᵀ @ u``: ``(B, n) → (B, M)`` via the
    ELL slot layout — see :class:`InterpPlan`.  Same f32 sums as the
    scatter-add form (short per-node reductions, no cumsum), so it is valid
    for the exact CG path and SLQ probes."""
    # Elementwise multiply + sum — NOT an einsum/dot: a K-contraction dot
    # could be routed to the tensor cores and TF32-rounded at DEFAULT
    # precision; this form is exact f32 regardless of the precision config.
    out = jnp.sum(plan.slot_w[None, :, :] * u_bm[:, plan.slot_src], axis=-1)
    if int(plan.ov_ids.shape[0]) > 0:
        out = out.at[:, plan.ov_ids].add(
            plan.ov_w[None, :] * u_bm[:, plan.ov_src]
        )
    return out


def interp_matvec_bm_fast(plan: InterpPlan, v_grid_bm: jax.Array) -> jax.Array:
    """Batch-major ``W @ v`` via one fused gather over all ``2^d`` corners:
    ``(B, M) → (B, n)``.  Exact (same sums as :func:`interp_matvec_bm`, just
    one gather kernel instead of ``2^d``)."""
    g = v_grid_bm[:, plan.gather_flat]  # (B, 2^d, n)
    return jnp.sum(plan.gather_w[None, :, :] * g, axis=1)


def interp_expand(iw: InterpWeights) -> jax.Array:
    """Densify ``W`` to ``(n, M)`` — test oracle only."""
    n = iw.idx[0].shape[0]
    M = math.prod(iw.shape)
    eye = jnp.eye(M, dtype=iw.w[0].dtype)
    return interp_matvec(iw, eye)
