"""GPSKIRegression with the windowed interpolation path vs the flat path.

The windowed applies are gated to the n ≳ m regime (points per cell);
these tests force the gate both ways on one small problem and require the
solver outputs to agree — the two paths compute the same short f32 sums,
merely reordered.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.kernels.stationary import make_kernel
from gp_grief_jax.models.gp_ski import GPSKIRegression
from gp_grief_jax.ops.interp_windowed import build_windowed_plan, make_windowed_ops


def _model(n=400, md=6, d=3, seed=0, **kw):
    # f64 on CPU (suite convention: conftest enables x64; mixed f32 data
    # under x64 promotes inconsistently through cov_grid).
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, d))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.05 * rng.standard_normal(n)
    xg = tuple(np.linspace(0, 1, md)[:, None] for _ in range(d))
    return GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.4), xg, noise_var=0.05,
        num_probes=8, lanczos_iters=20, **kw
    )


def _force_windowed(m):
    m._wplan = build_windowed_plan(m.iw, cell_block=32, point_block=64)
    assert m._wplan is not None
    m._w_ops = make_windowed_ops(m._wplan)
    return m


def _force_flat(m):
    m._wplan = None
    m._w_ops = None
    return m


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["data", "lattice"])
def test_windowed_model_matches_flat(solver):
    # n=400 > M=216: the regime the windowed path targets.
    kw = dict(solver=solver, precond_rank=32)
    m_win = _force_windowed(_model(**kw))
    m_flat = _force_flat(_model(**kw))

    ll_w = m_win.log_likelihood()
    ll_f = m_flat.log_likelihood()
    assert np.isfinite(ll_w)
    np.testing.assert_allclose(ll_w, ll_f, rtol=2e-4)

    xs = np.random.default_rng(7).uniform(0, 1, size=(50, 3))
    mu_w, var_w = m_win.predict(xs)
    mu_f, var_f = m_flat.predict(xs)
    np.testing.assert_allclose(mu_w, mu_f, atol=5e-4)
    np.testing.assert_allclose(var_w, var_f, atol=5e-4)


def test_windowed_kernel_matvec_matches():
    m_win = _force_windowed(_model())
    m_flat = _force_flat(_model())
    v = np.random.default_rng(3).standard_normal(400)
    a = np.asarray(m_win.kernel_matvec(jnp.asarray(v)))
    b = np.asarray(m_flat.kernel_matvec(jnp.asarray(v)))
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_windowed_segmented_nlml_matches():
    kw = dict(solver="lattice", precond_rank=0)
    m_win = _force_windowed(_model(**kw))
    m_flat = _force_flat(_model(**kw))
    a = m_win.log_likelihood_segmented(cg_segment_iters=25, probe_chunk=4)
    b = m_flat.log_likelihood_segmented(cg_segment_iters=25, probe_chunk=4)
    np.testing.assert_allclose(a, b, rtol=2e-4)
