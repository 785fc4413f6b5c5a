"""Edge cases real data hits: constant feature columns (m_d = 1 grid dims),
single-point predictions, p=1 bases, 1-D grids, tiny n."""

import jax.numpy as jnp
import numpy as np

from gp_grief_jax import (
    GPGriefModel,
    GPKroneckerRegression,
    GPRegression,
    InducingGrid,
    make_kernel,
)


def test_constant_feature_column(rng):
    # dim 1 is constant -> its grid has a single point (m_d = 1).
    n = 60
    x = np.stack([rng.uniform(0, 4, n), np.full(n, 2.5)], axis=1)
    y = np.sin(2 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    grid = InducingGrid.build(x, mbar=10)
    assert grid.grid_shape[1] == 1
    model = GPGriefModel(
        x, y, [make_kernel("rbf", lengthscale=0.5) for _ in range(2)], grid,
        n_eigs=8, noise_var=0.1,
    )
    assert np.isfinite(model.log_likelihood())
    model.optimize(max_iters=20)
    mean, var = model.predict(x[:1])  # single test point
    assert mean.shape == (1,) and np.isfinite(mean[0]) and var[0] >= 0


def test_p_equals_one(rng):
    x = rng.uniform(0, 1, size=(30, 1))
    y = x[:, 0] * 0.5 + 0.01 * rng.standard_normal(30)
    model = GPGriefModel(x, y, [make_kernel("rbf")], n_eigs=1, mbar=8, noise_var=0.1)
    assert np.isfinite(model.log_likelihood())
    assert model.checkgrad()


def test_tiny_n(rng):
    x = np.asarray([[0.1], [0.9]])
    y = np.asarray([0.0, 1.0])
    m = GPRegression(x, y, make_kernel("rbf", lengthscale=0.5), noise_var=0.01)
    mean, var = m.predict(np.asarray([[0.5]]))
    assert np.isfinite(mean[0]) and var[0] > 0
    g = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=2, mbar=5, noise_var=0.01)
    assert np.isfinite(g.log_likelihood())


def test_one_dimensional_kron_grid(rng):
    # Single-dimension "Kronecker" structure degenerates to a plain GP.
    g0 = np.linspace(0, 1, 12)
    y = np.sin(5 * g0) + 0.02 * rng.standard_normal(12)
    kron = GPKroneckerRegression([g0[:, None]], y, [make_kernel("rbf", lengthscale=0.3)], noise_var=0.02)
    dense = GPRegression(g0[:, None], y, make_kernel("rbf", lengthscale=0.3), noise_var=0.02)
    np.testing.assert_allclose(kron.log_likelihood(), dense.log_likelihood(), rtol=1e-9)
