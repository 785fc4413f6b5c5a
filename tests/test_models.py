"""Model tests: exact-GP NLML/predict vs an independent NumPy float64 oracle,
GPGrief ≈ exact GP on-grid, checkgrad on every model, optimization smoke,
GPKronecker vs dense, GPweb equivalence (SURVEY.md §4 rebuild strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax import (
    GPGriefModel,
    GPKroneckerRegression,
    GPRegression,
    GPweb,
    InducingGrid,
    make_kernel,
)
from gp_grief_jax.kernels import build_basis, phi


# ---------------------------------------------------------------------------
# Independent NumPy oracle (no JAX) — SURVEY.md §4: "our own float64
# NumPy/SciPy GPRegression is the oracle for 1e-4 parity".
# ---------------------------------------------------------------------------


def np_rbf(x, z, ell, var):
    r2 = ((x[:, None, :] - z[None, :, :]) / ell) ** 2
    return var * np.exp(-0.5 * r2.sum(-1))


def np_gp_nlml(x, y, ell, var, noise):
    n = len(y)
    K = np_rbf(x, x, ell, var) + noise * np.eye(n)
    L = np.linalg.cholesky(K)
    a = np.linalg.solve(L, y)
    return 0.5 * (a @ a) + np.log(np.diag(L)).sum() + 0.5 * n * np.log(2 * np.pi)


def np_gp_predict(x, y, xs, ell, var, noise):
    K = np_rbf(x, x, ell, var) + noise * np.eye(len(y))
    Ks = np_rbf(xs, x, ell, var)
    alpha = np.linalg.solve(K, y)
    mean = Ks @ alpha
    v = np.linalg.solve(K, Ks.T)
    var_pred = np.diag(np_rbf(xs, xs, ell, var)) - np.sum(Ks.T * v, axis=0)
    return mean, var_pred


def _sine_data(rng, n=80, noise=0.1):
    x = rng.uniform(0, 4, size=(n, 1))
    y = np.sin(2 * x[:, 0]) + noise * rng.standard_normal(n)
    return x, y


def test_gp_regression_matches_numpy_oracle(rng):
    x, y = _sine_data(rng)
    ell, var, noise = 0.7, 1.3, 0.05
    model = GPRegression(x, y, make_kernel("rbf", lengthscale=ell, variance=var), noise_var=noise)
    ref_nlml = np_gp_nlml(x, y, ell, var, noise)
    np.testing.assert_allclose(-model.log_likelihood(), ref_nlml, rtol=1e-10)

    xs = np.linspace(0, 4, 25)[:, None]
    mean, var_pred = model.predict(xs)
    ref_mean, ref_var = np_gp_predict(x, y, xs, ell, var, noise)
    np.testing.assert_allclose(mean, ref_mean, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var_pred, ref_var, rtol=1e-6, atol=1e-10)


def test_gp_regression_checkgrad(rng):
    x, y = _sine_data(rng, n=40)
    model = GPRegression(x, y, make_kernel("matern52", lengthscale=0.9), noise_var=0.1)
    assert model.checkgrad()


def test_gp_regression_optimize_improves(rng):
    x, y = _sine_data(rng, n=60)
    model = GPRegression(x, y, make_kernel("rbf", lengthscale=3.0, variance=0.5), noise_var=1.0)
    ll0 = model.log_likelihood()
    res = model.optimize(max_iters=50)
    assert model.log_likelihood() > ll0 + 1.0
    assert np.all(np.isfinite(res.losses))


def test_gp_grief_on_grid_equals_exact(rng):
    # On-grid data + full basis (p = m): GRIEF NLML == exact GP NLML, and
    # predictions match (SURVEY.md §4: model parity on tiny on-grid problems).
    m1, m2 = 6, 5
    g0 = np.linspace(0, 1, m1)
    g1 = np.linspace(0, 2, m2)
    pts = np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2)
    rng_local = np.random.default_rng(1)
    y = np.sin(3 * pts[:, 0]) * np.cos(pts[:, 1]) + 0.05 * rng_local.standard_normal(len(pts))
    kerns = [make_kernel("rbf", lengthscale=0.4), make_kernel("rbf", lengthscale=0.8)]
    grid = InducingGrid.build(pts, mbar=10)
    assert grid.grid_shape == (m1, m2)
    noise = 0.05

    grief = GPGriefModel(pts, y, kerns, grid, n_eigs=m1 * m2, noise_var=noise, dim_noise_var=0.0)
    exact = GPRegression(pts, y, kerns, noise_var=noise)
    np.testing.assert_allclose(
        grief.log_likelihood(), exact.log_likelihood(), rtol=1e-8
    )
    xs = rng_local.uniform(0.1, 0.9, size=(12, 2))
    gm, gv = grief.predict(xs)
    # On-grid training + full basis makes train-kernel exact; test-point
    # Nystrom extension is near-exact for points inside the grid.
    em, ev = exact.predict(xs)
    np.testing.assert_allclose(gm, em, atol=5e-4)


def test_gp_grief_checkgrad_reweight(rng):
    x, y = _sine_data(rng, n=50)
    grid = InducingGrid.build(x, mbar=12)
    model = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=8, noise_var=0.1)
    assert model.checkgrad()


def test_gp_grief_checkgrad_opt_kernel_params(rng):
    x, y = _sine_data(rng, n=40)
    grid = InducingGrid.build(x, mbar=10)
    model = GPGriefModel(
        x, y, [make_kernel("rbf", lengthscale=0.5)], grid,
        n_eigs=6, noise_var=0.1, opt_kernel_params=True, dim_noise_var=1e-8,
    )
    assert model.checkgrad()


def test_gp_grief_optimize_and_fit_quality(rng):
    # 1D sine config (BASELINE.json config 1, shrunk): fit quality after
    # optimizing weights + noise.
    x, y = _sine_data(rng, n=200, noise=0.05)
    grid = InducingGrid.build(x, mbar=40)
    model = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=20, noise_var=0.5)
    model.optimize(max_iters=100)
    xs = np.linspace(0.2, 3.8, 50)[:, None]
    mean = model.predict(xs, compute_var=False)
    rmse = np.sqrt(np.mean((mean - np.sin(2 * xs[:, 0])) ** 2))
    assert rmse < 0.08


def test_gp_kronecker_matches_dense(rng):
    g0 = np.linspace(0, 1, 5)
    g1 = np.linspace(-1, 1, 4)
    pts = np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2)
    y = rng.standard_normal(len(pts))
    kerns = [make_kernel("matern32", lengthscale=0.6), make_kernel("rbf", lengthscale=0.9)]
    noise = 0.3
    kron = GPKroneckerRegression([g0[:, None], g1[:, None]], y, kerns, noise_var=noise)
    dense = GPRegression(pts, y, kerns, noise_var=noise)
    np.testing.assert_allclose(kron.log_likelihood(), dense.log_likelihood(), rtol=1e-9)

    xs = rng.uniform(0, 1, size=(7, 2))
    km, kv = kron.predict(xs)
    dm, dv = dense.predict(xs)
    np.testing.assert_allclose(km, dm, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(kv, dv, rtol=1e-6, atol=1e-9)
    assert kron.checkgrad()


def test_gp_kronecker_cg_solver(rng):
    g0 = np.linspace(0, 1, 4)
    g1 = np.linspace(0, 1, 3)
    y = rng.standard_normal(12)
    kerns = [make_kernel("rbf", lengthscale=0.5), make_kernel("rbf", lengthscale=0.5)]
    schur = GPKroneckerRegression([g0[:, None], g1[:, None]], y, kerns, noise_var=0.2, solver="schur")
    cg = GPKroneckerRegression([g0[:, None], g1[:, None]], y, kerns, noise_var=0.2, solver="cg")
    np.testing.assert_allclose(cg.log_likelihood(), schur.log_likelihood(), rtol=1e-8)


def test_gp_web_equals_grief_given_same_basis(rng):
    x, y = _sine_data(rng, n=60)
    grid = InducingGrid.build(x, mbar=15)
    kerns = [make_kernel("rbf", lengthscale=0.5)]
    p = 10
    model = GPGriefModel(x, y, kerns, grid, n_eigs=p, noise_var=0.1)
    xg = [jnp.asarray(g) for g in grid.xg]
    basis = build_basis(kerns, xg, p)
    Phi = phi(basis, kerns, xg, jnp.asarray(x))
    web = GPweb(Phi, y, noise_var=0.1)
    np.testing.assert_allclose(web.log_likelihood(), model.log_likelihood(), rtol=1e-9)
    assert web.checkgrad()
    # Training the web model improves its likelihood.
    ll0 = web.log_likelihood()
    web.optimize(max_iters=40)
    assert web.log_likelihood() >= ll0


def test_gp_web_chunked_stats_match(rng):
    """Row-chunked ΦᵀΦ/Φᵀy reductions (round-3 weak #5) must be exact: a
    GPweb whose stats scanned 4 chunks (with padding) equals the one-shot."""
    n, p = 103, 7  # deliberately not a multiple of the chunk
    Phi = rng.standard_normal((n, p))
    y = rng.standard_normal(n)
    one = GPweb(Phi, y, noise_var=0.3, stats_chunk=n)
    chunked = GPweb(Phi, y, noise_var=0.3, stats_chunk=25)
    np.testing.assert_allclose(np.asarray(chunked.stats.C), np.asarray(one.stats.C), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(chunked.stats.v), np.asarray(one.stats.v), rtol=1e-12)
    np.testing.assert_allclose(float(chunked.stats.yy), float(one.stats.yy), rtol=1e-12)
    np.testing.assert_allclose(chunked.log_likelihood(), one.log_likelihood(), rtol=1e-10)


def test_gp_web_chunked_stats_mixed_dtypes(rng):
    """Scan-carry dtype must follow the promoted Φᵀy dtype (round-4 review):
    f64 Φ with f32 y under x64 must not crash, and must match the one-shot."""
    Phi = rng.standard_normal((60, 5))  # float64 under x64
    y = rng.standard_normal(60).astype(np.float32)
    one = GPweb(Phi, y, noise_var=0.3, stats_chunk=60)
    chunked = GPweb(Phi, y, noise_var=0.3, stats_chunk=16)
    np.testing.assert_allclose(
        chunked.log_likelihood(), one.log_likelihood(), rtol=1e-6
    )


def test_gp_regression_matrix_free_predict_empty(rng):
    """predict on zero test points returns empty arrays (round-4 review:
    the chunked host loop crashed on range step 0)."""
    from gp_grief_jax import GPRegression

    n = 60
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    it = GPRegression(
        x, y, make_kernel("rbf", lengthscale=0.8), noise_var=0.1,
        solver="iterative", cg_iters=100, matvec_chunk=32,
    )
    mean, var = it.predict(np.empty((0, 2)))
    assert mean.shape == (0,) and var.shape == (0,)
    mean2 = it.predict(np.empty((0, 2)), compute_var=False)
    assert mean2.shape == (0,)


def test_sq_dist_self_pairs_snap_to_zero(rng):
    """The matmul distance form snaps sub-cancellation-noise r² to exact 0
    (round-4 review: Matérn √r² amplified ~eps residue on self-pairs when
    the same block appears in both arguments with same=False)."""
    import gp_grief_jax.kernels.stationary as st

    xs = jnp.asarray(rng.uniform(-5, 5, size=(40, 2)).astype(np.float32))
    orig = st._EXACT_DIST_MAX_ELEMS
    try:
        st._EXACT_DIST_MAX_ELEMS = 0  # force the matmul branch
        r2 = st._sq_dist(xs[:9], xs, same=False)  # block-of-itself case
    finally:
        st._EXACT_DIST_MAX_ELEMS = orig
    diag = np.asarray(r2)[np.arange(9), np.arange(9)]
    np.testing.assert_array_equal(diag, 0.0)


def test_sq_dist_large_nm_uses_matmul_form(rng):
    """Round-3 weak #4: d≤4 at large n·m must NOT broadcast an (n, m, d)
    intermediate.  Gate check + accuracy of the matmul form at d=2."""
    from gp_grief_jax.kernels.stationary import _sq_dist, _use_broadcast_dist

    assert _use_broadcast_dist(100, 100, 2)
    assert not _use_broadcast_dist(20000, 20000, 2)  # 4e8 elems > 2^24
    assert not _use_broadcast_dist(100, 100, 5)  # d gate unchanged
    # The matmul form (forced by a large virtual n·m via monkey sizes is
    # awkward; instead compare both forms directly on the same small data).
    xs = jnp.asarray(rng.uniform(-2, 2, size=(60, 2)))
    zs = jnp.asarray(rng.uniform(-2, 2, size=(40, 2)))
    exact = jnp.sum((xs[:, None, :] - zs[None, :, :]) ** 2, axis=-1)
    import gp_grief_jax.kernels.stationary as st

    orig = st._EXACT_DIST_MAX_ELEMS
    try:
        st._EXACT_DIST_MAX_ELEMS = 0  # force the matmul branch
        got = _sq_dist(xs, zs, same=False)
    finally:
        st._EXACT_DIST_MAX_ELEMS = orig
    np.testing.assert_allclose(np.asarray(got), np.asarray(exact), rtol=1e-9, atol=1e-10)


@pytest.mark.slow
def test_gp_grief_d100_stress(rng):
    # BASELINE.json config 5: d=100 grid → 10^100+ virtual inducing points;
    # basis build + predict must succeed.
    d, n, p = 100, 20, 16
    x = rng.uniform(0, 1, size=(n, d))
    grid = InducingGrid.build(x, mbar=10)
    assert grid.log10_num_virtual >= 99.9
    model = GPGriefModel(
        x, rng.standard_normal(n), make_kernel("rbf", lengthscale=2.0), grid,
        n_eigs=p, noise_var=0.1,
    )
    ll = model.log_likelihood()
    assert np.isfinite(ll)
    mean, var = model.predict(x[:5])
    assert np.all(np.isfinite(mean)) and np.all(np.isfinite(var)) and np.all(var >= 0)


def test_gp_grief_chunked_stats_match(rng):
    # Force the scan-chunked reduction path and compare against direct stats.
    x, y = _sine_data(rng, n=100)
    grid = InducingGrid.build(x, mbar=15)
    kerns = [make_kernel("rbf", lengthscale=0.5)]
    a = GPGriefModel(x, y, kerns, grid, n_eigs=8, noise_var=0.2)
    b = GPGriefModel(x, y, kerns, grid, n_eigs=8, noise_var=0.2)
    b.stats_chunk = 17  # 100 rows -> 6 chunks with padding
    b._refresh_cache()
    np.testing.assert_allclose(np.asarray(b._stats.C), np.asarray(a._stats.C), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(b._stats.v), np.asarray(a._stats.v), rtol=1e-10)
    np.testing.assert_allclose(float(b._stats.yy), float(a._stats.yy), rtol=1e-12)
    np.testing.assert_allclose(b.log_likelihood(), a.log_likelihood(), rtol=1e-10)


def test_gp_web_predict_matches_grief(rng):
    x, y = _sine_data(rng, n=70)
    grid = InducingGrid.build(x, mbar=12)
    kerns = [make_kernel("rbf", lengthscale=0.5)]
    p = 8
    grief = GPGriefModel(x, y, kerns, grid, n_eigs=p, noise_var=0.1)
    xg = [jnp.asarray(g) for g in grid.xg]
    basis = build_basis(kerns, xg, p)
    web = GPweb(phi(basis, kerns, xg, jnp.asarray(x)), y, noise_var=0.1)

    xs = np.linspace(0.2, 3.8, 9)[:, None]
    Phis = phi(basis, kerns, xg, jnp.asarray(xs))
    wm, wv = web.predict(Phis)
    gm, gv = grief.predict(xs)
    np.testing.assert_allclose(wm, gm, rtol=1e-9)
    np.testing.assert_allclose(wv, gv, rtol=1e-8)
    # include_noise adds exactly sigma^2
    wm2, wv2 = web.predict(Phis, include_noise=True)
    np.testing.assert_allclose(wv2 - wv, np.exp(float(web.params["log_noise"])), rtol=1e-9)


def test_gp_grief_kmeans_grid(rng):
    # eq=False exercises the 1D k-means placement path end to end.
    x, y = _sine_data(rng, n=150)
    grid = InducingGrid.build(x, mbar=20, eq=False)
    model = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=12, noise_var=0.2)
    model.optimize(max_iters=30)
    mean = model.predict(np.linspace(0.3, 3.7, 20)[:, None], compute_var=False)
    rmse = float(np.sqrt(np.mean((mean - np.sin(2 * np.linspace(0.3, 3.7, 20))) ** 2)))
    assert rmse < 0.15


def test_flat_parameters_roundtrip(rng):
    # Reference API parity: BaseModel.parameters flat get/set.
    x, y = _sine_data(rng, n=40)
    m = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=8, noise_var=0.2)
    vec = m.parameters
    ll0 = m.log_likelihood()
    vec2 = vec.copy()
    vec2[-1] += 0.3  # perturb one entry
    m.parameters = vec2
    assert m.log_likelihood() != ll0
    m.parameters = vec
    np.testing.assert_allclose(m.log_likelihood(), ll0, rtol=1e-12)
    import pytest as _pytest
    with _pytest.raises(ValueError):
        m.parameters = vec[:-1]


def test_fix_free_parameters():
    """Reference per-parameter fix/free surface (SURVEY §2 #10/#15)."""
    import gp_grief_jax as gpx

    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (200, 2))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(200)
    grid = gpx.InducingGrid.build(x, mbar=8)
    m = gpx.GPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(2)],
        grid, n_eigs=12, noise_var=0.3,
    )
    noise0 = float(m.params["log_noise"])
    w0 = np.asarray(m.params["log_w"]).copy()
    m.fix("log_noise")
    assert "log_noise" in m.fixed_parameters
    m.optimize(max_iters=10, optimizer="adam")
    assert float(m.params["log_noise"]) == noise0  # fixed: untouched
    assert np.abs(np.asarray(m.params["log_w"]) - w0).max() > 1e-6  # free moved
    m.free()
    assert m.fixed_parameters == []
    m.optimize(max_iters=5, optimizer="adam")
    assert float(m.params["log_noise"]) != noise0  # now it moves

    import pytest

    with pytest.raises(ValueError):
        m.fix("no_such_param")


def test_fix_elementwise_mask():
    """Array-valued masks fix individual components through fit()."""
    import jax.numpy as jnp

    from gp_grief_jax.optimize import fit

    def loss(p):
        return jnp.sum((p["a"] - 3.0) ** 2) + (p["b"] - 1.0) ** 2

    params = {"a": jnp.zeros(4), "b": jnp.zeros(())}
    mask = {"a": np.array([True, False, True, False]), "b": False}
    res = fit(loss, params, optimizer="adam", learning_rate=0.2, max_iters=200, fixed=mask)
    a = np.asarray(res.params["a"])
    assert abs(a[0]) < 1e-8 and abs(a[2]) < 1e-8  # fixed components pinned
    assert abs(a[1] - 3.0) < 1e-2 and abs(a[3] - 3.0) < 1e-2
    assert abs(float(res.params["b"]) - 1.0) < 1e-2


def test_kron_svd_oracle():
    from gp_grief_jax.ops import kron_expand, kron_svd

    rng = np.random.default_rng(7)
    fs = tuple(jnp.asarray(rng.standard_normal((m, m))) for m in (4, 3, 5))
    Us, Ss, Vs = kron_svd(fs)
    # Reconstruct each factor and the full product.
    for K, U, S, V in zip(fs, Us, Ss, Vs):
        np.testing.assert_allclose(
            np.asarray(U) * np.asarray(S) @ np.asarray(V).T, np.asarray(K),
            rtol=1e-8, atol=1e-8,
        )
    dense = np.asarray(kron_expand(fs))
    sv_kron = np.sort(np.asarray(kron_expand([jnp.diag(s) for s in Ss])).diagonal())[::-1]
    sv_dense = np.linalg.svd(dense, compute_uv=False)
    np.testing.assert_allclose(sv_kron, sv_dense, rtol=1e-8, atol=1e-10)


def test_kron_predict_chunked_matches_unchunked():
    import gp_grief_jax as gpx

    rng = np.random.default_rng(11)
    xg = [np.linspace(0, 1, 7)[:, None], np.linspace(0, 1, 6)[:, None], np.linspace(0, 1, 5)[:, None]]
    grid_pts = np.stack(np.meshgrid(*[g[:, 0] for g in xg], indexing="ij"), -1).reshape(-1, 3)
    y = np.sin(3 * grid_pts[:, 0]) * np.cos(2 * grid_pts[:, 1]) + 0.01 * rng.standard_normal(len(grid_pts))
    m = gpx.GPKroneckerRegression(xg, y, [gpx.make_kernel("rbf", lengthscale=0.4)] * 3, noise_var=0.01)
    xs = rng.uniform(0, 1, (23, 3))
    mean1, var1 = m.predict(xs, chunk=23)
    mean2, var2 = m.predict(xs, chunk=4)  # pads 23 -> 24
    np.testing.assert_allclose(mean1, mean2, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var1, var2, rtol=1e-6, atol=1e-10)


def test_checkgrad_catches_bug_under_large_objective():
    """A 1e-2 per-parameter gradient bug at |f|~1e6 must be CAUGHT (the
    round-1 global noise floor 1e-8*(1+|f|) would have hidden it)."""
    from gp_grief_jax.optimize import checkgrad

    @jax.custom_vjp
    def buggy(x):
        return jnp.sum(x**2) + 1.0e6

    def fwd(x):
        return buggy(x), x

    def bwd(x, g):
        grad = 2.0 * x
        grad = grad.at[1].add(1e-2)  # deliberate bug in one component
        return (g * grad,)

    buggy.defvjp(fwd, bwd)

    params = jnp.asarray(np.linspace(0.5, 2.0, 4))
    ok, rows = checkgrad(lambda p: buggy(p), params)
    assert not ok
    # and a correct gradient at the same |f| passes
    ok2, _ = checkgrad(lambda p: jnp.sum(p**2) + 1.0e6, params)
    assert ok2


def test_predict_empty_inputs(rng):
    """All chunked predict paths return empty arrays on zero test points
    instead of dividing by a zero chunk (round-4 review)."""
    g0 = np.linspace(0, 1, 6)
    y = rng.standard_normal(36)
    kron = GPKroneckerRegression(
        [g0[:, None]] * 2, y, [make_kernel("rbf", lengthscale=0.5)] * 2,
        noise_var=0.2,
    )
    m0, v0 = kron.predict(np.empty((0, 2)))
    assert m0.shape == (0,) and v0.shape == (0,)
    from gp_grief_jax import GPSKIRegression

    x = rng.uniform(0, 1, size=(50, 2))
    ys = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(50)
    ski = GPSKIRegression(
        x, ys, make_kernel("rbf", lengthscale=0.5), mbar=6, noise_var=0.2,
        num_probes=4, lanczos_iters=10, cg_iters=50,
    )
    m1, v1 = ski.predict(np.empty((0, 2)))
    assert m1.shape == (0,) and v1.shape == (0,)


def test_checkgrad_sampled(rng):
    """sample=k probes ~k components (scalar leaves always included) and
    still catches a bug planted in a scalar hyper (round-3 weak #3)."""
    from gp_grief_jax.optimize import _checkgrad_indices, checkgrad

    params = {"log_w": jnp.asarray(rng.standard_normal(50)),
              "log_noise": jnp.asarray(0.3)}
    idx = list(_checkgrad_indices(params, 51, sample=8, seed=0))
    # pytree dict leaves flatten key-sorted: log_noise (scalar) is index 0
    assert len(idx) <= 8 and 0 in idx  # scalar leaf always present
    assert list(_checkgrad_indices(params, 51, sample=None, seed=0)) == list(range(51))

    def loss(p):
        return jnp.sum(jnp.exp(p["log_w"]) ** 2) + 10.0 * p["log_noise"] ** 2

    ok, rows = checkgrad(loss, params, sample=8)
    assert ok and len(rows) <= 8

    @jax.custom_vjp
    def buggy_scalar(s):
        return 10.0 * s**2

    def fwd(s):
        return buggy_scalar(s), s

    def bwd(s, g):
        return (g * (20.0 * s + 0.5),)

    buggy_scalar.defvjp(fwd, bwd)
    bad_loss = lambda p: jnp.sum(jnp.exp(p["log_w"]) ** 2) + buggy_scalar(p["log_noise"])
    ok2, _ = checkgrad(bad_loss, params, sample=8)
    assert not ok2  # the always-included scalar hyper caught it


def test_gp_kronecker_mixed16_matches_schur(rng):
    """cg_precision='mixed16' (bf16 inner-CG state + bf16 fast matvec) must
    reach the same NLML as the schur closed form — accuracy comes from the
    exact residual refreshes, not the inner state dtype."""
    g0 = np.linspace(0, 1, 8)
    g1 = np.linspace(0, 1, 6)
    y = rng.standard_normal(48)
    kerns = [make_kernel("rbf", lengthscale=0.5), make_kernel("rbf", lengthscale=0.5)]
    kw = dict(noise_var=0.2, cg_iters=600)
    schur = GPKroneckerRegression([g0[:, None], g1[:, None]], y, kerns, noise_var=0.2, solver="schur")
    m16 = GPKroneckerRegression(
        [g0[:, None], g1[:, None]], y, kerns, solver="cg", cg_precision="mixed16", **kw
    )
    np.testing.assert_allclose(m16.log_likelihood(), schur.log_likelihood(), rtol=1e-6)
    with pytest.raises(ValueError):
        GPKroneckerRegression(
            [g0[:, None]], y[:8], kerns[:1], solver="cg", cg_precision="bogus"
        )


def test_gpkron_segmented_nlml_matches(rng):
    """GPKroneckerRegression.log_likelihood_segmented == the monolithic CG
    NLML (both deterministic: closed-form log-det + converged CG), with and
    without the Kronecker-deflation preconditioner."""
    gs = [np.linspace(0, 1, 7)[:, None], np.linspace(0, 2, 6)[:, None]]
    yg = rng.standard_normal(42)
    for r in (0, 12):
        m = GPKroneckerRegression(
            gs, yg, [make_kernel("rbf", lengthscale=0.4),
                     make_kernel("matern32", lengthscale=0.7)],
            noise_var=0.3, solver="cg", cg_tol=1e-12, cg_iters=300,
            precond_rank=r,
        )
        mono = m.log_likelihood()
        seg = m.log_likelihood_segmented(cg_segment_iters=20)
        assert abs(seg - mono) / abs(mono) < 1e-8


def test_gpkron_segmented_whitened_and_cached(rng):
    """The whitened segmented branch (cg_whiten=True) matches the monolithic
    NLML, and repeated evaluations reuse the compile-once program set
    (bit-identical repeats; geometry change rebuilds)."""
    from gp_grief_jax.models.gp_kron import GPKroneckerRegression

    gs = [np.linspace(0, 1, 7)[:, None], np.linspace(0, 2, 6)[:, None]]
    yg = rng.standard_normal(42)
    m = GPKroneckerRegression(
        gs, yg, [make_kernel("rbf", lengthscale=0.4),
                 make_kernel("matern32", lengthscale=0.7)],
        noise_var=0.3, solver="cg", cg_tol=1e-12, cg_iters=300,
        precond_rank=12, cg_whiten=True,
    )
    mono = m.log_likelihood()
    seg = m.log_likelihood_segmented(cg_segment_iters=20)
    assert abs(seg - mono) / abs(mono) < 1e-8
    progs = m._nlml_progs
    seg2 = m.log_likelihood_segmented(cg_segment_iters=20)
    assert m._nlml_progs is progs and seg2 == seg
    m.log_likelihood_segmented(cg_segment_iters=40)
    assert m._nlml_progs is not progs


def test_constructors_reject_mismatched_xy(rng):
    """Every model constructor must raise ValueError on an x/y length
    mismatch instead of broadcasting into a wrong-answer fit (reference
    BaseModel guards — SURVEY.md §2 #15; found by a round-2 verify probe)."""
    from gp_grief_jax import GPSKIRegression

    x = rng.uniform(0, 1, size=(50, 2))
    y = rng.standard_normal(50)
    xg = [np.linspace(0, 1, 8)[:, None]] * 2
    kerns = [make_kernel("rbf", lengthscale=0.3)] * 2
    # (n, 1) responses auto-flatten (the reference accepted column vectors)
    GPSKIRegression(x, y[:, None], kerns, xg)
    with pytest.raises(ValueError):
        GPSKIRegression(x, y[:10], kerns, xg)
    with pytest.raises(ValueError):
        GPRegression(x, y[:10], make_kernel("rbf"))
    with pytest.raises(ValueError):
        GPGriefModel(x, y[:10], kerns, n_eigs=5)
    with pytest.raises(ValueError):
        GPweb(rng.standard_normal((50, 4)), y[:10])
    with pytest.raises(ValueError):
        GPKroneckerRegression(xg, y, kerns)  # 64 grid points, 50 responses


def test_gp_kron_grouped_dims_predict(rng):
    """Grouped grid dimensions (sub_dim > 1) through GPKroneckerRegression
    NLML *and* predict against a dense f64
    oracle: K = K_0 ⊗ K_1 with a 2-column second grid dimension; cross-covs
    are the row-Khatri-Rao of per-group kernels."""
    from gp_grief_jax.kernels.grid import cov_grid, cross_cov_grid
    from gp_grief_jax.models.gp_kron import GPKroneckerRegression

    m0, m1 = 6, 20
    xg = [
        np.linspace(0, 1, m0)[:, None],
        rng.uniform(0, 1, size=(m1, 2)),  # one grid dim spanning 2 columns
    ]
    m = m0 * m1
    y = rng.standard_normal(m)
    kerns = [
        make_kernel("rbf", lengthscale=0.4),
        make_kernel("matern52", lengthscale=0.6, input_dim=2),
    ]
    sigma2 = 0.3
    model = GPKroneckerRegression(xg, y, kerns, noise_var=sigma2)
    assert model.dims == ((0,), (1, 2))

    # dense oracle
    K0, K1 = (np.asarray(K) for K in cov_grid(kerns, [jnp.asarray(g) for g in xg]))
    K = np.kron(K0, K1)
    A = K + sigma2 * np.eye(m)
    Ainv_y = np.linalg.solve(A, y)
    ll_oracle = -0.5 * (
        y @ Ainv_y + np.linalg.slogdet(A)[1] + m * np.log(2 * np.pi)
    )
    np.testing.assert_allclose(model.log_likelihood(), ll_oracle, rtol=1e-8)

    c = 7
    x_new = rng.uniform(0, 1, size=(c, 3))
    Kx0, Kx1 = (
        np.asarray(K)
        for K in cross_cov_grid(
            kerns, jnp.asarray(x_new), [jnp.asarray(g) for g in xg],
            dims=model.dims,
        )
    )
    KxU = np.stack([np.kron(Kx0[i], Kx1[i]) for i in range(c)])  # (c, m)
    mean_o = KxU @ Ainv_y
    prior = np.array(
        [np.exp(kerns[0].log_variance) * np.exp(kerns[1].log_variance)] * c
    )
    var_o = prior - np.einsum("cm,cm->c", KxU, np.linalg.solve(A, KxU.T).T)
    mean, var = model.predict(x_new)
    np.testing.assert_allclose(mean, mean_o, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(var, var_o, rtol=1e-5, atol=1e-8)

    # wrong test-point width fails loudly; explicit dims= validates widths
    with pytest.raises(ValueError, match="columns"):
        model.predict(x_new[:, :2])
    with pytest.raises(ValueError, match="widths"):
        GPKroneckerRegression(xg, y, kerns, dims=[[0], [1]])


def test_grief_phi_impl_grad_prefers_batched(rng):
    """GPGriefModel._loss assembles Φ through phi(impl='auto'), which takes
    the batched stack when the dims batch; the loss and its gradient match
    the same objective built on the per-dim loop (impl='xla')."""
    import jax

    import gp_grief_jax as gpx
    from gp_grief_jax.kernels.grief import phi, stack_kernels
    from gp_grief_jax.models.base import BasisStats, basis_nlml

    n, d = 150, 6
    x = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    y = np.sin(3 * x[:, 0]).astype(np.float32)
    grid = gpx.InducingGrid.build(x, mbar=8)
    kerns = [gpx.make_kernel("rbf", lengthscale=1.0) for _ in range(d)]
    m = gpx.GPGriefModel(
        x, y, kerns, grid, n_eigs=40, noise_var=0.1, dtype=np.float32,
        opt_kernel_params=True, dim_noise_var=1e-8,
    )
    assert stack_kernels(m.params["kernels"], m.xg, m.dims) is not None
    basis = m._build(m.params["kernels"])
    np.testing.assert_array_equal(
        np.asarray(phi(basis, m.params["kernels"], m.xg, m.x)),
        np.asarray(phi(basis, m.params["kernels"], m.xg, m.x, impl="batched")),
    )

    def loss_xla(params):
        b = m._build(params["kernels"])
        Phi = phi(b, params["kernels"], m.xg, m.x, impl="xla")
        stats = BasisStats(C=Phi.T @ Phi, v=Phi.T @ m.y, yy=jnp.dot(m.y, m.y), n=n)
        return basis_nlml(stats, params["log_w"], params["log_noise"])

    l_auto = float(m._loss(m.params))
    l_xla = float(loss_xla(m.params))
    np.testing.assert_allclose(l_auto, l_xla, rtol=5e-4)
    # Grads agree across assemblies too (the ARD training surface).
    g_auto = jax.grad(m._loss)(m.params)
    g_xla = jax.grad(loss_xla)(m.params)
    fa = np.concatenate([np.ravel(np.asarray(v)) for v in jax.tree.leaves(g_auto)])
    fx = np.concatenate([np.ravel(np.asarray(v)) for v in jax.tree.leaves(g_xla)])
    np.testing.assert_allclose(fa, fx, rtol=2e-2, atol=5e-4)
