"""Checks that need the card: f32 results on the GPU against float64
references computed on the CPU in the same process.

They skip on a CPU-only backend (``gpu`` fixture in conftest.py).  Run on a
GPU host with ``GP_GRIEF_TEST_GPU=1 python -m pytest tests/test_gpu.py -m
gpu``; ``chip_smoke.py`` runs them first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_gpu_kron_chain_precisions(gpu):
    """HIGHEST is exact f32 on the card; DEFAULT runs the wide groups in
    TF32 (10-bit mantissa: ~1e-3 relative)."""
    from gp_grief_jax.ops import kron_matvec_fast

    rng = np.random.default_rng(0)
    sizes = (16, 16, 16, 16)
    fs = [rng.standard_normal((m, m)) / np.sqrt(m) for m in sizes]
    v = rng.standard_normal(int(np.prod(sizes)))
    x = v.reshape(sizes)
    for i, K in enumerate(fs):
        x = np.moveaxis(np.tensordot(K, x, axes=(1, i)), 0, i)
    ref = x.reshape(-1)
    fs32 = tuple(jax.device_put(np.float32(K), gpu) for K in fs)
    v32 = jax.device_put(np.float32(v), gpu)
    hi = kron_matvec_fast(fs32, v32, precision=jax.lax.Precision.HIGHEST)
    lo = kron_matvec_fast(fs32, v32, precision=jax.lax.Precision.DEFAULT)
    assert hi.devices() == {gpu}
    assert _rel(hi, ref) < 1e-5
    assert _rel(lo, ref) < 1e-2


def test_gpu_grief_nlml_matches_cpu_f64(gpu):
    import gp_grief_jax as gpx

    rng = np.random.default_rng(1)
    n, d = 2000, 3
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(2 * x[:, 0]) * x[:, 1] + 0.1 * rng.standard_normal(n)
    grid = gpx.InducingGrid.build(x, mbar=10)

    def nlml(dtype):
        kerns = [gpx.make_kernel("rbf", lengthscale=0.6) for _ in range(d)]
        m = gpx.GPGriefModel(
            x.astype(dtype), y.astype(dtype), kerns, grid, n_eigs=100,
            noise_var=0.1, dtype=dtype, opt_kernel_params=True, dim_noise_var=1e-6,
        )
        return float(m.log_likelihood())

    ll32 = nlml(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        ll64 = nlml(np.float64)
    assert abs(ll32 - ll64) / abs(ll64) < 1e-4


def test_gpu_stencil_device_tables_match_host(gpu, monkeypatch):
    """The device table build (atomic scatter-adds, f32) against the host
    f64 bincount build."""
    import gp_grief_jax.ops.interp_stencil as mod
    from gp_grief_jax.ops.interp import interp_weights

    rng = np.random.default_rng(2)
    shape = (16, 16, 16)
    xg = [np.linspace(0, 1, m) for m in shape]
    x = rng.uniform(0, 1, (50_000, 3))
    iw = interp_weights(x, xg)
    host = mod.build_wtw_stencil(iw)
    monkeypatch.setattr(mod, "DEVICE_BUILD_MIN", 0)
    dev = mod.build_wtw_stencil(iw)
    assert dev.tables.devices() == {gpu}
    assert dev.deltas == host.deltas
    assert _rel(dev.tables, host.tables) < 1e-5
