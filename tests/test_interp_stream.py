"""CornerStream invariants: the shared host-side corner-update stream.

The stream (ops/interp.py:build_corner_stream) underlies every
interpolation plan builder; these tests pin its structural claims against
a brute-force per-dim oracle (the reference's SelectionMatrixSparse /
KhatriRaoMatrix semantics — SURVEY.md §2 #2/#4):

* every corner's flat index is exactly ``base + consts[k]`` (including
  clipped corners of degenerate ``m_d = 1`` dims, whose weight is 0);
* the pruned stream is the exact multiset of nonzero (cell, point, weight)
  updates;
* per-cell ranks are a permutation of ``0..count−1`` (the property the
  ELL fills rely on for collision-free scatter assignment);
* plans built with a shared stream equal plans built without one.
"""

import itertools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gp_grief_jax.ops.interp import (
    build_corner_stream,
    build_interp_plan,
    interp_expand,
    interp_weights,
)
from gp_grief_jax.ops.interp_windowed import build_windowed_plan, plan_split


def _oracle_corners(iw):
    """Corner flats/weights via the per-dim min() arithmetic (unpruned)."""
    d = len(iw.shape)
    n = int(np.asarray(iw.idx[0]).shape[0])
    idx_h = [np.asarray(ix) for ix in iw.idx]
    w_h = [np.asarray(w) for w in iw.w]
    flats, weights = [], []
    for offsets in itertools.product((0, 1), repeat=d):
        flat = None
        # Same dtype and multiply order as build_corner_stream → bit-equal.
        w = np.ones(n, dtype=w_h[0].dtype)
        for dd, off in enumerate(offsets):
            comp = np.minimum(idx_h[dd] + off, iw.shape[dd] - 1)
            flat = comp if flat is None else flat * iw.shape[dd] + comp
            w = w * w_h[dd][:, off]
        flats.append(flat.astype(np.int64))
        weights.append(w)
    return np.stack(flats), np.stack(weights)


def _make_iw(rng, n, shape, on_grid_frac=0.1):
    d = len(shape)
    x = rng.uniform(0.0, 1.0, size=(n, d)).astype(np.float32)
    xg = [np.linspace(0.0, 1.0, m).astype(np.float32) for m in shape]
    # Park some points exactly on grid lines → zero weights to prune.
    k = max(1, int(on_grid_frac * n))
    for dd in range(d):
        if shape[dd] >= 2:
            x[:k, dd] = xg[dd][min(1, shape[dd] - 1)]
    return interp_weights(jnp.asarray(x), [jnp.asarray(g) for g in xg])


@pytest.mark.parametrize(
    "n,shape",
    [(400, (7, 5, 4)), (1500, (6, 6)), (250, (9, 1, 5)), (64, (4, 4, 4, 4))],
)
def test_corner_stream_matches_oracle(n, shape):
    rng = np.random.default_rng(0)
    iw = _make_iw(rng, n, shape)
    st = build_corner_stream(iw)
    M = math.prod(shape)
    flats_o, w_o = _oracle_corners(iw)

    # base + consts reproduces every corner flat, clipped corners included.
    pred = st.base[None, :].astype(np.int64) + st.consts[:, None]
    np.testing.assert_array_equal(pred, flats_o)
    # unpruned per-corner weights (sorted-point order) match the oracle
    np.testing.assert_array_equal(st.w_pts_sorted[:, st.inv_perm], w_o)

    # pruned stream: exact multiset of nonzero (cell, data-point, weight)
    nz = w_o.reshape(-1) != 0
    assert st.flat_u.shape[0] == int(nz.sum())
    ref_flat = flats_o.reshape(-1)[nz]
    ref_src = np.tile(np.arange(n), 2 ** len(shape))[nz]
    ref_w = w_o.reshape(-1)[nz]
    src_data = st.perm[st.src_u]
    got = sorted(zip(st.flat_u.tolist(), src_data.tolist(), st.w_u.astype(np.float64).tolist()))
    ref = sorted(zip(ref_flat.tolist(), ref_src.tolist(), ref_w.tolist()))
    assert got == ref

    # ranks: a permutation of 0..c-1 within each cell; counts consistent
    cnts = np.bincount(st.flat_u, minlength=M)
    np.testing.assert_array_equal(cnts, st.counts)
    order = np.argsort(
        st.flat_u.astype(np.int64) * (len(st.flat_u) + 1) + st.rank_u
    )
    rs = st.rank_u[order]
    exp = np.concatenate([np.arange(c) for c in cnts if c > 0])
    np.testing.assert_array_equal(rs, exp)
    # tail curve consistent with the rank histogram
    L = len(st.rank_u)
    for k in (1, 2, 5):
        if k - 1 < len(st.tail):
            assert int(st.tail[k - 1]) == int(np.sum(st.rank_u >= k))


def test_plans_with_shared_stream_match_streamless():
    rng = np.random.default_rng(1)
    iw = _make_iw(rng, 600, (8, 7))
    st = build_corner_stream(iw)
    a = build_interp_plan(iw)
    b = build_interp_plan(iw, stream=st)
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if f == "shape":
            assert va == vb
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    wa = build_windowed_plan(iw)
    wb = build_windowed_plan(iw, stream=st)
    (arr_a, st_a), (arr_b, st_b) = plan_split(wa), plan_split(wb)
    assert st_a == st_b
    for va, vb in zip(arr_a, arr_b):
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_interp_plan_cumsum_pointers_cover_dense_oracle():
    """start/end pointers in the counting-sort layout still reproduce Wᵀu
    against the dense W (empty cells land on equal pointers → exact 0)."""
    from gp_grief_jax.ops.interp import interp_rmatvec_bm_fast

    rng = np.random.default_rng(2)
    iw = _make_iw(rng, 300, (5, 4, 3))  # M=60 ≫ occupied cells at n=300? no: force empties
    # tiny n so some cells are empty
    iw2 = _make_iw(rng, 12, (6, 6, 3))
    for cur in (iw, iw2):
        plan = build_interp_plan(cur)
        W = np.asarray(interp_expand(cur))  # (n, M)
        u = rng.standard_normal((3, W.shape[0])).astype(np.float32)
        out = np.asarray(interp_rmatvec_bm_fast(plan, jnp.asarray(u)))
        ref = u @ W
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
