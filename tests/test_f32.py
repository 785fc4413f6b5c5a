"""float32 coverage: the accelerator execution dtype must work end to end (parity
tests run f64; these guard the f32 path that actually runs on hardware)."""

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax import GPGriefModel, GPRegression, InducingGrid, make_kernel
from gp_grief_jax.ops import kron_eigh, kron_expand, kron_matvec_fast, top_p_kron_eigs


def test_kron_fast_f32(rng):
    fs = tuple(
        jnp.asarray(rng.standard_normal((m, m)), dtype=jnp.float32) for m in (4, 3, 2)
    )
    K = np.asarray(kron_expand(fs), dtype=np.float64)
    v = rng.standard_normal(24).astype(np.float32)
    got = np.asarray(kron_matvec_fast(fs, jnp.asarray(v), target_width=8))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, K @ v, rtol=2e-5, atol=2e-5)


def test_top_p_f32_no_underflow(rng):
    lams = [jnp.asarray(rng.uniform(1e-8, 1e4, size=6), dtype=jnp.float32) for _ in range(20)]
    log_lam, idx = top_p_kron_eigs(lams, 50)
    assert log_lam.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(log_lam)))


def test_grief_model_f32_end_to_end(rng):
    x = rng.uniform(0, 4, size=(300, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(300)).astype(np.float32)
    grid = InducingGrid.build(x, mbar=12)
    model = GPGriefModel(
        x, y, [make_kernel("rbf", lengthscale=0.5) for _ in range(2)], grid,
        n_eigs=30, noise_var=0.2, dtype=np.float32, dim_noise_var=1e-6,
    )
    assert model.params["log_w"].dtype == jnp.float32
    ll0 = model.log_likelihood()
    model.optimize(optimizer="adam", max_iters=60, learning_rate=0.05)
    assert model.log_likelihood() > ll0
    mean, var = model.predict(x[:20])
    assert mean.dtype == np.float32 and np.all(np.isfinite(mean))
    assert np.all(var >= 0)
    rmse = float(np.sqrt(np.mean((mean - np.sin(2 * x[:20, 0]) * np.cos(x[:20, 1])) ** 2)))
    assert rmse < 0.15


def test_exact_gp_f32(rng):
    x = rng.uniform(0, 3, size=(100, 1)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.05 * rng.standard_normal(100)).astype(np.float32)
    m = GPRegression(x, y, make_kernel("rbf", lengthscale=0.7), noise_var=0.05)
    # params default to f64 under x64; cast data path works regardless: just
    # check finite NLML and sane predictions in mixed precision.
    assert np.isfinite(m.log_likelihood())
    mean, var = m.predict(x[:10])
    assert np.all(np.isfinite(mean)) and np.all(var >= 0)


def test_gp_kronecker_f32_large_grid_finite(rng):
    # f32 eigh round-off gives small negative eigenvalues; amplified by the
    # other dims' lambda_max in the Kronecker product they once made
    # log(lam + sigma^2) NaN (found at 128^3 in f32). The PSD clamp fixes it.
    gs = [np.linspace(0, 1, 64).astype(np.float32)[:, None] for _ in range(2)]
    pts = np.stack(
        np.meshgrid(gs[0][:, 0], gs[1][:, 0], indexing="ij"), -1
    ).reshape(-1, 2)
    y = (np.sin(4 * pts[:, 0]) + 0.05 * rng.standard_normal(len(pts))).astype(np.float32)
    kerns = [make_kernel("rbf", lengthscale=0.3) for _ in range(2)]
    kerns = [jax.tree.map(lambda a: a.astype(jnp.float32), k) for k in kerns]
    from gp_grief_jax.models import GPKroneckerRegression

    m = GPKroneckerRegression(gs, y, kerns, noise_var=0.05, dim_noise_var=1e-6)
    assert np.isfinite(m.log_likelihood())
    mean, var = m.predict(np.asarray([[0.5, 0.5]], dtype=np.float32))
    assert np.isfinite(mean[0]) and var[0] >= 0
