"""Extended kernel zoo: closed forms, PSD-ness, combinators, model integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax import GPRegression, make_kernel
from gp_grief_jax.kernels import (
    Constant,
    Cosine,
    Linear,
    Product,
    Sum,
    White,
    make_periodic,
    make_ratquad,
)
from gp_grief_jax.kernels.base import inverse_positive


def test_ratquad_limits_and_closed_form(rng):
    x = jnp.asarray(np.sort(rng.standard_normal(8))[:, None])
    rq = make_ratquad(lengthscale=0.9, variance=1.4, alpha=2.5)
    K = np.asarray(rq(x))
    r2 = (np.asarray(x) - np.asarray(x).T) ** 2 / 0.81
    np.testing.assert_allclose(K, 1.4 * (1 + r2 / 5.0) ** (-2.5), rtol=1e-10)
    # alpha → ∞ approaches RBF
    rq_inf = make_ratquad(lengthscale=0.9, variance=1.4, alpha=1e7)
    rbf = make_kernel("rbf", lengthscale=0.9, variance=1.4)
    np.testing.assert_allclose(np.asarray(rq_inf(x)), np.asarray(rbf(x)), rtol=1e-5)


def test_periodic_is_periodic(rng):
    per = make_periodic(lengthscale=1.0, variance=2.0, period=0.5)
    x = jnp.asarray([[0.1]])
    z = jnp.asarray([[0.6], [1.1], [0.35]])
    K = np.asarray(per(x, z))
    np.testing.assert_allclose(K[0, 0], 2.0, rtol=1e-10)  # exactly one period away
    np.testing.assert_allclose(K[0, 1], 2.0, rtol=1e-10)
    assert K[0, 2] < 2.0


def test_white_constant_linear(rng):
    x = jnp.asarray(rng.standard_normal((5, 2)))
    z = jnp.asarray(rng.standard_normal((3, 2)))
    w = White(log_variance=inverse_positive(0.3))
    np.testing.assert_allclose(np.asarray(w(x)), 0.3 * np.eye(5), rtol=1e-12)
    assert np.all(np.asarray(w(x, z)) == 0)
    # Coincident PAIRS across two argument sets must see σ² (the matrix-free
    # Gram matvec evaluates k(x_block, x) with z≠None — round-4 review).
    Kxx = np.asarray(w(x[:3], x))
    np.testing.assert_allclose(Kxx, 0.3 * np.eye(5)[:3], rtol=1e-12)
    c = Constant(log_variance=inverse_positive(2.0))
    np.testing.assert_allclose(np.asarray(c(x, z)), 2.0, rtol=1e-12)
    lin = Linear(log_variances=inverse_positive(jnp.asarray([1.0, 4.0])))
    ref = np.asarray(x) * np.array([1.0, 4.0]) @ np.asarray(z).T
    np.testing.assert_allclose(np.asarray(lin(x, z)), ref, rtol=1e-10)


def test_sum_product_combinators_and_grads(rng):
    x = jnp.asarray(rng.standard_normal((10, 1)))
    k = Sum(
        k1=Product(k1=make_kernel("rbf", lengthscale=0.5), k2=make_periodic(period=1.0)),
        k2=White(log_variance=inverse_positive(0.1)),
    )
    K = np.asarray(k(x))
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    assert np.linalg.eigvalsh(K).min() > 0

    def f(kern):
        return jnp.sum(kern(x))

    g = jax.grad(f)(k)
    assert np.isfinite(float(g.k1.k2.log_period))
    assert np.isfinite(float(g.k2.log_variance))


def test_composite_kernel_in_gp_regression(rng):
    n = 50
    x = np.linspace(0, 4, n)[:, None]
    y = np.sin(2 * np.pi * x[:, 0]) + 0.02 * rng.standard_normal(n)
    k = Product(k1=make_kernel("rbf", lengthscale=2.0), k2=make_periodic(period=1.05))
    model = GPRegression(x, y, k, noise_var=0.05)
    assert model.checkgrad()
    ll0 = model.log_likelihood()
    model.optimize(max_iters=40)
    assert model.log_likelihood() > ll0
    mean, var = model.predict(np.asarray([[4.5], [5.0]]))
    assert np.all(np.isfinite(mean)) and np.all(var > 0)


def test_composite_kernel_on_grid_models(rng):
    """Sum/Product composite kernels work as per-dimension grid kernels
    (GridKernel capability, SURVEY §2 #12): gp_kron NLML matches a dense f64
    oracle built from the same composite factors."""
    from gp_grief_jax.kernels.grid import cov_grid
    from gp_grief_jax.models.gp_kron import GPKroneckerRegression

    k1 = Sum(make_kernel("rbf", lengthscale=0.3),
             make_kernel("matern32", lengthscale=1.0))
    k2 = make_ratquad(lengthscale=0.5)
    xg = [np.linspace(0, 1, 7)[:, None], np.linspace(0, 1, 6)[:, None]]
    y = rng.standard_normal(42)
    m = GPKroneckerRegression(xg, y, [k1, k2], noise_var=0.2)
    K0, K1 = (np.asarray(K) for K in cov_grid([k1, k2], m.xg))
    A = np.kron(K0, K1) + 0.2 * np.eye(42)
    ll = -0.5 * (y @ np.linalg.solve(A, y) + np.linalg.slogdet(A)[1]
                 + 42 * np.log(2 * np.pi))
    np.testing.assert_allclose(m.log_likelihood(), ll, rtol=1e-8)
    mean, var = m.predict(rng.uniform(0, 1, size=(5, 2)))
    assert np.all(np.isfinite(mean)) and np.all(var >= 0)
