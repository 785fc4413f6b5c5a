"""Regression tests for the round-1 code-review findings (all were verified
bugs before the fixes)."""

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax import GPGriefModel, GPRegression, InducingGrid, make_kernel
from gp_grief_jax.models.gp_ski import GPSKIRegression
from gp_grief_jax.ops import stable_cholesky
from gp_grief_jax.ops.cg import cg_solve
from gp_grief_jax.ops.interp import interp_matvec, interp_weights


def test_interp_weights_single_point_dim(rng):
    # Finding 1: m_d = 1 grid dims produced NaN weights.
    xg = [jnp.asarray(np.linspace(0, 1, 6)[:, None]), jnp.asarray([[2.5]])]
    x = jnp.asarray(np.stack([rng.uniform(0, 1, 10), np.full(10, 2.5)], axis=1))
    iw = interp_weights(x, xg)
    assert np.all(np.isfinite(np.asarray(iw.w[1])))
    v = jnp.asarray(rng.standard_normal(6))
    out = interp_matvec(iw, v)
    assert np.all(np.isfinite(np.asarray(out)))
    # SKI end-to-end with a constant feature column
    y = np.sin(4 * np.asarray(x)[:, 0]) + 0.01 * rng.standard_normal(10)
    ski = GPSKIRegression(np.asarray(x), y, [make_kernel("rbf")] * 2, xg, noise_var=0.1)
    assert np.isfinite(ski.log_likelihood())


def test_refresh_basis_invalidates_nlml(rng):
    # Finding 2: log_likelihood() returned stale values after refresh_basis().
    x = rng.uniform(0, 4, size=(50, 1))
    y = np.sin(2 * x[:, 0])
    m = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=8, mbar=10, noise_var=0.1)
    ll_old = m.log_likelihood()
    new_params = dict(m.params)
    new_params["kernels"] = [make_kernel("rbf", lengthscale=1.5)]
    m.params = new_params
    m.refresh_basis()
    ll_new = m.log_likelihood()
    fresh = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=1.5)], n_eigs=8, mbar=10, noise_var=0.1)
    np.testing.assert_allclose(ll_new, fresh.log_likelihood(), rtol=1e-10)
    assert abs(ll_new - ll_old) > 1e-6


def test_stable_cholesky_gradients_finite(rng):
    # Finding 3: failed jitter attempts leaked NaN gradients.
    U = rng.standard_normal((6, 2))
    A = jnp.asarray(U @ U.T)  # singular: first attempt fails

    def f(scale):
        L, _ = stable_cholesky(A * scale)
        return jnp.sum(L)

    g = jax.grad(f)(1.0)
    assert np.isfinite(float(g))


def test_kernel_matvec_with_opt_kernel_params(rng):
    # Finding 4: AttributeError (no _basis) before any predict call.
    x = rng.uniform(0, 4, size=(40, 1))
    y = np.sin(2 * x[:, 0])
    m = GPGriefModel(
        x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=8,
        noise_var=0.1, opt_kernel_params=True,
    )
    out = m.kernel_matvec(jnp.asarray(rng.standard_normal(40)))
    assert np.all(np.isfinite(np.asarray(out)))
    assert np.isfinite(m.log_likelihood_iterative(num_probes=16, lanczos_iters=20))


def test_cg_tolerance_clamped_in_f32(rng):
    # Finding 5: sub-eps tolerances spun every f32 solve to max_iters.
    n = 50
    A_np = rng.standard_normal((n, n)).astype(np.float32)
    A = jnp.asarray(A_np @ A_np.T + n * np.eye(n, dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    x, info = cg_solve(lambda v: A @ v, b, tol=1e-12, max_iters=400, return_info=True)
    assert int(info.iterations) < 300  # stops at f32 stagnation, not max_iters
    ref = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-3, atol=1e-4)


def test_inplace_kernel_mutation_detected(rng):
    # Review round 2, finding 1: mutating self.params in place must invalidate
    # the cached basis (identity check missed it).
    x = rng.uniform(0, 4, size=(40, 1))
    y = np.sin(2 * x[:, 0])
    m = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=8, noise_var=0.1)
    m.predict(x[:3])
    m.params["kernels"] = [make_kernel("rbf", lengthscale=1.7)]  # in-place
    mean2 = m.predict(x[:3], compute_var=False)
    fresh = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=1.7)], n_eigs=6, mbar=8, noise_var=0.1)
    np.testing.assert_allclose(mean2, fresh.predict(x[:3], compute_var=False), rtol=1e-10)


def test_log_likelihood_order_independent(rng):
    # Review round 2, finding 2: log_likelihood after a params change must not
    # depend on whether predict() happened to run in between.
    x = rng.uniform(0, 4, size=(40, 1))
    y = np.sin(2 * x[:, 0])

    def make_pair():
        m = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=8, noise_var=0.1)
        m.log_likelihood()
        m.params = {**m.params, "kernels": [make_kernel("rbf", lengthscale=1.4)]}
        return m

    a = make_pair()
    ll_direct = a.log_likelihood()
    b = make_pair()
    b.predict(x[:2])
    ll_after_predict = b.log_likelihood()
    np.testing.assert_allclose(ll_direct, ll_after_predict, rtol=1e-12)


def test_reweight_optimize_no_spurious_rebuild(rng):
    # Review round 2, finding 3: reweight-only training leaves kernels
    # bit-identical, so predict must NOT re-run the O(n p^2) reductions.
    x = rng.uniform(0, 4, size=(60, 1))
    y = np.sin(2 * x[:, 0])
    m = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=8, noise_var=0.1)
    m.optimize(max_iters=5)
    calls = {"n": 0}
    orig = m._refresh_cache

    def counting():
        calls["n"] += 1
        return orig()

    m._refresh_cache = counting
    m.predict(x[:3])
    m.log_likelihood()
    assert calls["n"] == 0


def test_gp_kron_integer_y_keeps_float_hyperparams(rng):
    """r13 review: the working-dtype cast must not truncate hyperparameters
    to int when y is integer-valued."""
    from gp_grief_jax.models.gp_kron import GPKroneckerRegression

    xg = [np.linspace(0, 1, 5)[:, None]] * 2
    y = np.arange(25)  # int64
    m = GPKroneckerRegression(xg, y, [make_kernel("rbf", lengthscale=0.4)] * 2,
                              noise_var=0.1)
    assert jnp.issubdtype(m.params["log_noise"].dtype, jnp.floating)
    for leaf in jax.tree_util.tree_leaves(m.params["kernels"]):
        assert jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)
    # noise_var round-trips (int truncation gave 0.135 for 0.1)
    np.testing.assert_allclose(
        float(jnp.exp(m.params["log_noise"])), 0.1, rtol=1e-6
    )


def test_gp_kron_dims_out_of_range_rejected(rng):
    """r13 review: out-of-range/duplicate dims indices must raise (JAX's
    clamped gather would silently mis-map columns in predict)."""
    import pytest

    from gp_grief_jax.models.gp_kron import GPKroneckerRegression

    xg = [np.linspace(0, 1, 4)[:, None], rng.uniform(0, 1, size=(5, 2))]
    y = rng.standard_normal(20)
    kerns = [make_kernel("rbf"), make_kernel("rbf", input_dim=2)]
    with pytest.raises(ValueError, match="distinct and in"):
        GPKroneckerRegression(xg, y, kerns, dims=[[0], [1, 3]])
    with pytest.raises(ValueError, match="distinct and in"):
        GPKroneckerRegression(xg, y, kerns, dims=[[1], [1, 2]])


def test_fit_rejected_step_keeps_clean_opt_state(rng):
    """r13 review: when a step evaluates non-finite, fit() must return the
    LAST GOOD optimizer state (not the rejected step's NaN-carrying
    moments) so resume stays usable."""
    from gp_grief_jax.optimize import fit

    def loss(p):
        # minimized toward w -> 2 where it is -inf/NaN beyond — big Adam
        # steps overshoot into the NaN region
        return jnp.log(2.0 - p["w"])

    res = fit(loss, {"w": jnp.asarray(0.0)}, optimizer="adam",
              max_iters=200, learning_rate=1.5, tol=0.0)
    assert res.iterations < 200  # it did hit the NaN break
    for leaf in jax.tree_util.tree_leaves(res.opt_state):
        assert np.all(np.isfinite(np.asarray(leaf, dtype=np.float64)))
    # resuming from the returned state stays finite for at least one step
    res2 = fit(loss, res.params, optimizer="adam", max_iters=1,
               learning_rate=1e-6, tol=0.0, opt_state=res.opt_state)
    assert np.isfinite(res2.losses).all()


def test_lowrank_spectral_factor_top_r_zero(rng):
    """r13 review: top_r=0 must return an EMPTY basis (V[:, -0:] sliced all
    columns)."""
    from gp_grief_jax.ops.precond import lowrank_spectral_factor

    F = jnp.asarray(rng.standard_normal((20, 6)))
    U, lam = lowrank_spectral_factor(F, top_r=0)
    assert U.shape == (20, 0) and lam.shape == (0,)
    U2, lam2 = lowrank_spectral_factor(F, top_r=2)
    assert U2.shape == (20, 2) and lam2.shape == (2,)
