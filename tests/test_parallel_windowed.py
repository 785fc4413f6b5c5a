"""Sharded SKI with windowed interpolation plans vs the flat stacked plans.

The windowed applies are gated to large shapes (`_WINDOWED_MIN_DIM`); these
tests force the gate on small meshes and require equality with the flat
sharded path — identical short f32 sums, reordered.
"""

import jax
import numpy as np
import pytest

from gp_grief_jax.kernels.stationary import make_kernel
from gp_grief_jax.parallel import ShardedGPSKIRegression
from gp_grief_jax.parallel.mesh import data_mesh


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(axis_name="data")


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _pair(rng, mesh, monkeypatch, solver, n=300, md=8, **kw):
    import gp_grief_jax.parallel.ski as pski

    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, md)[:, None]] * 2
    kern = make_kernel("rbf", lengthscale=0.6)
    flat = ShardedGPSKIRegression(x, y, kern, xg, mesh=mesh, solver=solver, **kw)
    assert not flat._use_windowed
    monkeypatch.setattr(pski, "_WINDOWED_MIN_DIM", 0)
    win = ShardedGPSKIRegression(x, y, kern, xg, mesh=mesh, solver=solver, **kw)
    assert win._use_windowed and win._plan is None
    return flat, win, x


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["data", "lattice"])
def test_sharded_windowed_matches_flat(rng, mesh, monkeypatch, solver):
    kw = dict(noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=300,
              cg_tol=1e-10, precond_rank=32)
    flat, win, x = _pair(rng, mesh, monkeypatch, solver, **kw)
    ll_f, ll_w = flat.log_likelihood(), win.log_likelihood()
    assert np.isfinite(ll_w)
    np.testing.assert_allclose(ll_w, ll_f, rtol=5e-7)

    # Gradients flow through the windowed applies inside shard_map.
    from jax.flatten_util import ravel_pytree

    gw = np.asarray(ravel_pytree(jax.grad(win._loss)(win.params))[0])
    gf = np.asarray(ravel_pytree(jax.grad(flat._loss)(flat.params))[0])
    assert np.all(np.isfinite(gw))
    np.testing.assert_allclose(gw, gf, rtol=5e-5, atol=1e-8)

    xs = np.random.default_rng(7).uniform(0.1, 1.9, size=(23, 2))
    mf, vf = flat.predict(xs)
    mw, vw = win.predict(xs)
    np.testing.assert_allclose(mw, mf, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(vw, vf, rtol=1e-5, atol=1e-8)


def test_sharded_windowed_optimize_improves(rng, mesh, monkeypatch):
    import gp_grief_jax.parallel.ski as pski

    monkeypatch.setattr(pski, "_WINDOWED_MIN_DIM", 0)
    n = 160
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 6)[:, None]] * 2
    sh = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=1.5), xg, mesh=mesh,
        noise_var=0.5, num_probes=16, lanczos_iters=30, cg_iters=200,
        cg_tol=1e-8, precond_rank=36,
    )
    assert sh._use_windowed
    ll0 = sh.log_likelihood()
    res = sh.optimize(optimizer="adam", max_iters=15, learning_rate=0.1)
    assert sh.log_likelihood() > ll0
    assert np.all(np.isfinite(res.losses))
