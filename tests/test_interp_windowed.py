"""Windowed interpolation applies vs the dense-W oracle (CPU f64/f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.ops.interp import (
    build_interp_plan,
    interp_expand,
    interp_matvec_bm_fast,
    interp_rmatvec_bm_exact,
    interp_weights,
)
from gp_grief_jax.ops.interp_windowed import (
    build_windowed_plan,
    make_windowed_ops,
    windowed_matvec_bm,
    windowed_matvec_bm_sorted,
    windowed_rmatvec_bm,
    windowed_rmatvec_bm_sorted,
)


def _setup(n, shape, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    d = len(shape)
    xg = tuple(np.sort(rng.uniform(0, 1, size=(m,))).astype(dtype)[:, None] for m in shape)
    x = rng.uniform(-0.1, 1.1, size=(n, d)).astype(dtype)  # incl. clamped pts
    iw = interp_weights(jnp.asarray(x), tuple(jnp.asarray(g) for g in xg))
    return iw


@pytest.mark.parametrize(
    "n,shape,cb,pb",
    [
        (300, (7, 5, 4), 16, 32),     # n > M(140): the target regime
        (40, (6, 5, 4), 32, 16),      # n < M
        (128, (11,), 8, 64),          # 1-D
        (65, (4, 4, 3, 3), 24, 24),   # d=4, awkward sizes
    ],
)
def test_windowed_matches_dense_oracle(n, shape, cb, pb):
    iw = _setup(n, shape)
    W = np.asarray(interp_expand(iw))  # (n, M)
    plan = build_windowed_plan(iw, cell_block=cb, point_block=pb)
    assert plan is not None
    B = 3
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((B, n)).astype("float32"))
    v = jnp.asarray(rng.standard_normal((B, int(W.shape[1]))).astype("float32"))

    got_wt = np.asarray(windowed_rmatvec_bm(plan, u))
    np.testing.assert_allclose(got_wt, np.asarray(u) @ W, rtol=0, atol=1e-5)
    got_w = np.asarray(windowed_matvec_bm(plan, v))
    np.testing.assert_allclose(got_w, np.asarray(v) @ W.T, rtol=0, atol=1e-5)

    # Sorted-order forms compose with perm/inv_perm consistently.
    perm = np.asarray(plan.perm)
    got_wt_s = np.asarray(windowed_rmatvec_bm_sorted(plan, u[:, plan.perm]))
    np.testing.assert_allclose(got_wt_s, got_wt, atol=0)
    got_w_s = np.asarray(windowed_matvec_bm_sorted(plan, v))
    np.testing.assert_allclose(got_w_s[:, np.argsort(perm)], got_w, atol=0)


def test_windowed_matches_ell_plan_bitwise_shapes():
    # Same math as the flat ELL plan (both reorder the same short f32 sums).
    iw = _setup(500, (6, 6, 5), seed=3)
    plan_flat = build_interp_plan(iw)
    plan_win = build_windowed_plan(iw, cell_block=32, point_block=64)
    B = 2
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal((B, 500)).astype("float32"))
    v = jnp.asarray(rng.standard_normal((B, 180)).astype("float32"))
    a = np.asarray(interp_rmatvec_bm_exact(plan_flat, u))
    b = np.asarray(windowed_rmatvec_bm(plan_win, u))
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    c = np.asarray(interp_matvec_bm_fast(plan_flat, v))
    d = np.asarray(windowed_matvec_bm(plan_win, v))
    np.testing.assert_allclose(c, d, rtol=0, atol=2e-6)


def test_windowed_custom_vjp_is_adjoint():
    iw = _setup(200, (5, 5, 4), seed=5)
    plan = build_windowed_plan(iw, cell_block=25, point_block=32)
    mv, rmv = make_windowed_ops(plan)
    W = np.asarray(interp_expand(iw))
    Ws = W[np.asarray(plan.perm)]  # sorted-point-order W
    B, M, n = 2, W.shape[1], W.shape[0]
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.standard_normal((B, n)).astype("float32"))
    v = jnp.asarray(rng.standard_normal((B, M)).astype("float32"))

    # VJP of rmatvec (Wᵀ) applied to a lattice cotangent = W @ ct.
    _, vjp_r = jax.vjp(rmv, u)
    (got,) = vjp_r(v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(v) @ Ws.T, atol=1e-5)
    # VJP of matvec (W) applied to a point cotangent = Wᵀ @ ct.
    _, vjp_m = jax.vjp(mv, v)
    (got2,) = vjp_m(u)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(u) @ Ws, atol=1e-5)

    # grad flows through a scalar pipeline without error (and without
    # scatter: the custom VJP routes through the sibling direction).
    def f(vv):
        return jnp.sum(rmv(mv(vv)) ** 2)

    g = jax.grad(f)(v)
    assert np.all(np.isfinite(np.asarray(g)))


def test_windowed_b1_padding_matches():
    # B=1 applies run internally B=2-padded (ops/interp_windowed._pad_b1);
    # results must equal the B-row of a batched apply.
    iw = _setup(220, (6, 5, 4), seed=9)
    plan = build_windowed_plan(iw, cell_block=16, point_block=32)
    rng = np.random.default_rng(8)
    u = jnp.asarray(rng.standard_normal((3, 220)).astype("float32"))
    v = jnp.asarray(rng.standard_normal((3, 120)).astype("float32"))
    a = np.asarray(windowed_rmatvec_bm(plan, u[:1]))
    b = np.asarray(windowed_rmatvec_bm(plan, u))[:1]
    np.testing.assert_allclose(a, b, atol=0)
    c = np.asarray(windowed_matvec_bm(plan, v[:1]))
    d = np.asarray(windowed_matvec_bm(plan, v))[:1]
    np.testing.assert_allclose(c, d, atol=0)


def test_windowed_plan_window_limit_fallback():
    iw = _setup(400, (8, 8, 8), seed=6)
    assert build_windowed_plan(iw, window_limit=4) is None
