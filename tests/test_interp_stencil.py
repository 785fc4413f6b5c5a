"""WᵀW stencil (ops/interp_stencil.py) vs dense oracles."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gp_grief_jax.ops.interp import (
    build_corner_stream,
    interp_expand,
    interp_weights,
)
from gp_grief_jax.ops.interp_stencil import (
    build_wtw_stencil,
    make_wtw_stencil_op,
    wtw_stencil_bm,
)


def _case(rng, shape, n, spread=1.2):
    d = len(shape)
    xg = [jnp.asarray(np.sort(rng.uniform(0, 1, (m,)))) for m in shape]
    x = jnp.asarray(rng.uniform(-0.1, spread, (n, d)))  # exercises clamping
    iw = interp_weights(x, xg)
    W = np.asarray(interp_expand(iw))
    return iw, W


@pytest.mark.parametrize(
    "shape,n",
    [((6,), 17), ((5, 4), 30), ((5, 4, 3), 50), ((4, 3, 3, 2), 64), ((3, 1, 4), 21)],
)
def test_stencil_matches_dense_wtw(rng, shape, n):
    iw, W = _case(rng, shape, n)
    st = build_wtw_stencil(iw)
    assert st is not None
    assert len(st.deltas) <= 3 ** len(shape)
    M = math.prod(shape)
    v = jnp.asarray(rng.standard_normal((3, M)))
    ref = np.asarray(v) @ (W.T @ W).T
    got = wtw_stencil_bm(st, v)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-10, atol=1e-12)


def test_stencil_shares_stream_and_is_param_free(rng):
    shape, n = (5, 4, 3), 40
    iw, W = _case(rng, shape, n)
    stream = build_corner_stream(iw)
    st = build_wtw_stencil(iw, stream=stream)
    st2 = build_wtw_stencil(iw)
    np.testing.assert_allclose(
        np.asarray(st.tables), np.asarray(st2.tables), rtol=0, atol=0
    )
    assert st.deltas == st2.deltas


@pytest.mark.parametrize(
    "shape,n,B",
    [
        ((8, 6, 5, 4), 300, 2),  # leading stride 120: the single-window layout
        ((8, 32, 4, 2), 400, 5),  # leading stride 256: the 3-window layout
    ],
)
def test_stencil_xla_apply_matches_dense_wtw(rng, shape, n, B):
    """The XLA shifted-add apply at the lattices the removed kernel's two
    window layouts covered, against dense ``WᵀW`` in f64 and in f32."""
    from gp_grief_jax.ops.interp_stencil import _apply_xla

    iw, W = _case(rng, shape, n)
    st = build_wtw_stencil(iw)
    v = rng.standard_normal((B, math.prod(shape)))
    ref = v @ (W.T @ W).T
    got = _apply_xla((st.deltas, st.shape), st.tables, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-10, atol=1e-12)
    got32 = wtw_stencil_bm(
        st._replace(tables=st.tables.astype(jnp.float32)),
        jnp.asarray(v, jnp.float32),
    )
    assert got32.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got32), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,n", [((5, 4, 3), 60), ((8, 32, 4, 2), 400)])
def test_stencil_device_build_matches_host(rng, shape, n, monkeypatch):
    """Past DEVICE_BUILD_MIN the tables are built by one jitted scatter-add
    program (f32 accumulation); they match the host f64 bincount build."""
    import gp_grief_jax.ops.interp_stencil as mod

    iw, W = _case(rng, shape, n)
    host = build_wtw_stencil(iw)
    monkeypatch.setattr(mod, "DEVICE_BUILD_MIN", 0)
    dev = build_wtw_stencil(iw)
    assert dev.deltas == host.deltas and dev.shape == host.shape
    np.testing.assert_allclose(
        np.asarray(dev.tables), np.asarray(host.tables), rtol=1e-6, atol=1e-7
    )
    v = jnp.asarray(rng.standard_normal((2, math.prod(shape))))
    np.testing.assert_allclose(
        np.asarray(wtw_stencil_bm(dev, v)),
        np.asarray(v) @ (W.T @ W).T,
        rtol=1e-5, atol=1e-6,
    )


def test_stencil_vjp_is_self_adjoint(rng):
    shape, n = (5, 4, 3), 40
    iw, W = _case(rng, shape, n)
    st = build_wtw_stencil(iw)
    M = math.prod(shape)
    op = make_wtw_stencil_op(st)
    v = jnp.asarray(rng.standard_normal((2, M)))

    def f(v):
        return jnp.sum(jnp.sin(op(v)))

    g = jax.grad(f)(v)
    A = W.T @ W
    ref = np.cos(np.asarray(v) @ A.T) @ A  # Aᵀ = A
    np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-9, atol=1e-11)


def test_stencil_grad_through_jit_and_hoisting(rng):
    from gp_grief_jax.utils.closure import explicit_closure

    shape, n = (4, 4), 25
    iw, W = _case(rng, shape, n)
    st = build_wtw_stencil(iw)
    M = math.prod(shape)
    op = make_wtw_stencil_op(st)

    def loss(v):
        return jnp.sum(op(v) ** 2)

    v = jnp.asarray(rng.standard_normal((1, M)))
    pure, consts = explicit_closure(loss, jax.ShapeDtypeStruct(v.shape, v.dtype))
    got = jax.jit(jax.grad(pure, argnums=1))(consts, v)
    A = W.T @ W
    ref = 2.0 * (np.asarray(v) @ A.T) @ A
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-9, atol=1e-11)
    # The tables must ride as hoisted consts, not baked literals.
    total = sum(np.asarray(c).size for c in consts)
    assert total >= st.tables.size


def test_stencil_memory_gate():
    rng = np.random.default_rng(0)
    iw, _ = _case(rng, (6, 5, 4), 30)
    assert build_wtw_stencil(iw, max_table_bytes=64) is None


def test_stencil_empty_and_single_point(rng):
    xg = [jnp.asarray(np.linspace(0, 1, 5)), jnp.asarray(np.linspace(0, 1, 4))]
    iw = interp_weights(jnp.zeros((0, 2)), xg)
    st = build_wtw_stencil(iw)
    out = wtw_stencil_bm(st, jnp.ones((2, 20)))
    np.testing.assert_allclose(np.asarray(out), 0.0)

    iw1 = interp_weights(jnp.asarray([[0.3, 0.9]]), xg)
    st1 = build_wtw_stencil(iw1)
    W = np.asarray(interp_expand(iw1))
    v = jnp.asarray(np.random.default_rng(1).standard_normal((1, 20)))
    np.testing.assert_allclose(
        np.asarray(wtw_stencil_bm(st1, v)), np.asarray(v) @ (W.T @ W).T,
        rtol=1e-12, atol=1e-14,
    )
