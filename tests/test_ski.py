"""SKI interpolation operators vs dense oracle; GPSKIRegression accuracy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax import GPRegression, InducingGrid, make_kernel
from gp_grief_jax.models.gp_ski import GPSKIRegression
from gp_grief_jax.ops import kron_expand
from gp_grief_jax.ops.interp_windowed import build_windowed_plan, make_windowed_ops
from gp_grief_jax.ops.interp import (
    interp_expand,
    interp_matvec,
    interp_rmatvec,
    interp_weights,
)


def _grid(*ms):
    return [jnp.asarray(np.linspace(0, 1, m)[:, None]) for m in ms]


def test_interp_weights_partition_of_unity(rng):
    xg = _grid(7, 5)
    x = jnp.asarray(rng.uniform(0, 1, size=(20, 2)))
    iw = interp_weights(x, xg)
    W = np.asarray(interp_expand(iw))
    np.testing.assert_allclose(W.sum(axis=1), 1.0, rtol=1e-12)
    assert (W >= 0).all()
    # ≤ 2^d nonzeros per row
    assert (np.count_nonzero(W, axis=1) <= 4).all()


def test_interp_exact_on_grid_points(rng):
    xg = _grid(6, 4)
    g0 = np.asarray(xg[0])[:, 0]
    g1 = np.asarray(xg[1])[:, 0]
    pts = jnp.asarray(np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2))
    iw = interp_weights(pts, xg)
    v = jnp.asarray(rng.standard_normal(24))
    np.testing.assert_allclose(np.asarray(interp_matvec(iw, v)), np.asarray(v), atol=1e-12)


def test_interp_matvec_rmatvec_adjoint(rng):
    xg = _grid(5, 4, 3)
    x = jnp.asarray(rng.uniform(0, 1, size=(11, 3)))
    iw = interp_weights(x, xg)
    W = np.asarray(interp_expand(iw))
    v = rng.standard_normal(60)
    u = rng.standard_normal(11)
    np.testing.assert_allclose(np.asarray(interp_matvec(iw, jnp.asarray(v))), W @ v, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(interp_rmatvec(iw, jnp.asarray(u))), W.T @ u, rtol=1e-10)


def test_interp_linear_functions_exact(rng):
    # Linear interpolation reproduces affine functions inside the grid.
    xg = _grid(9, 8)
    g0 = np.asarray(xg[0])[:, 0]
    g1 = np.asarray(xg[1])[:, 0]
    grid_pts = np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2)
    f = lambda p: 2.0 * p[:, 0] - 0.7 * p[:, 1] + 0.3
    v = jnp.asarray(f(grid_pts))
    x = jnp.asarray(rng.uniform(0.05, 0.95, size=(30, 2)))
    iw = interp_weights(x, xg)
    np.testing.assert_allclose(np.asarray(interp_matvec(iw, v)), f(np.asarray(x)), rtol=1e-10)


def test_gp_ski_close_to_exact_gp(rng):
    # Dense grid → SKI kernel ≈ exact kernel; NLML and predictions close.
    n = 120
    x = rng.uniform(0.02, 0.98, size=(n, 2))
    y = np.sin(4 * x[:, 0]) + 0.5 * np.cos(3 * x[:, 1]) + 0.05 * rng.standard_normal(n)
    kerns = [make_kernel("rbf", lengthscale=0.3), make_kernel("rbf", lengthscale=0.4)]
    grid = [np.linspace(-0.02, 1.02, 40)[:, None]] * 2
    ski = GPSKIRegression(x, y, kerns, grid, noise_var=0.05, num_probes=64, lanczos_iters=50)
    exact = GPRegression(x, y, kerns, noise_var=0.05)
    assert abs(ski.log_likelihood() - exact.log_likelihood()) < 5.0
    xs = rng.uniform(0.1, 0.9, size=(15, 2))
    sm, sv = ski.predict(xs)
    em, ev = exact.predict(xs)
    np.testing.assert_allclose(sm, em, atol=0.02)
    np.testing.assert_allclose(sv, ev, atol=0.02)


@pytest.mark.slow
def test_gp_ski_optimize_improves(rng):
    n = 100
    x = rng.uniform(0, 1, size=(n, 1))
    y = np.sin(6 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    ski = GPSKIRegression(
        x, y, [make_kernel("rbf", lengthscale=0.5)], [np.linspace(-0.05, 1.05, 50)[:, None]],
        noise_var=0.5, num_probes=32, lanczos_iters=40,
    )
    ll0 = ski.log_likelihood()
    ski.optimize(optimizer="adam", max_iters=60, learning_rate=0.05)
    assert ski.log_likelihood() > ll0
    mean = ski.predict(x[:20], compute_var=False)
    rmse = float(np.sqrt(np.mean((mean - np.sin(6 * x[:20, 0])) ** 2)))
    assert rmse < 0.15


def test_ski_predict_chunked_matches_unchunked(rng):
    import gp_grief_jax as gpx

    x = rng.uniform(0, 1, (120, 2))
    y = np.sin(4 * x[:, 0]) + 0.1 * rng.standard_normal(120)
    m = gpx.GPSKIRegression(x, y, [gpx.make_kernel("rbf", lengthscale=0.3)] * 2, mbar=10, noise_var=0.05)
    xs = rng.uniform(0, 1, (37, 2))  # not a multiple of any chunk
    mean1, var1 = m.predict(xs, chunk=37)
    mean2, var2 = m.predict(xs, chunk=8)  # 37 pads to 40
    np.testing.assert_allclose(mean1, mean2, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var1, var2, rtol=1e-6, atol=1e-10)
    mean3 = m.predict(xs, compute_var=False, chunk=5)
    np.testing.assert_allclose(mean1, mean3, rtol=1e-8, atol=1e-10)


def test_interp_bm_variants_match(rng):
    """Batch-major interp ops == transposed column-major ops."""
    from gp_grief_jax.ops.interp import (
        interp_matvec, interp_matvec_bm, interp_rmatvec, interp_rmatvec_bm,
        interp_weights,
    )

    x = jnp.asarray(rng.uniform(0, 1, size=(40, 3)))
    xg = [jnp.linspace(0, 1, m)[:, None] for m in (5, 6, 4)]
    iw = interp_weights(x, xg)
    M = 5 * 6 * 4
    V = jnp.asarray(rng.standard_normal((M, 3)))
    U = jnp.asarray(rng.standard_normal((40, 3)))
    np.testing.assert_allclose(
        np.asarray(interp_matvec_bm(iw, V.T)), np.asarray(interp_matvec(iw, V)).T,
        rtol=1e-12, atol=1e-14,
    )
    np.testing.assert_allclose(
        np.asarray(interp_rmatvec_bm(iw, U.T)), np.asarray(interp_rmatvec(iw, U)).T,
        rtol=1e-12, atol=1e-14,
    )


def test_ski_matvec_batched_matches_columns(rng):
    """The batch-major (B>1) SKI matvec == per-column single matvecs."""
    import gp_grief_jax as gpx
    from gp_grief_jax.kernels.grid import cov_grid

    x = rng.uniform(0, 1, size=(60, 2))
    y = rng.standard_normal(60)
    m = gpx.GPSKIRegression(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.5) for _ in range(2)],
        mbar=7, noise_var=0.3,
    )
    factors = cov_grid(m.params["kernels"], m.xg, dim_noise_var=0.0)
    mv = m._matvec(factors, 0.3)
    V = jnp.asarray(rng.standard_normal((60, 4)))
    batched = np.asarray(mv(V))
    for j in range(4):
        col = np.asarray(mv(V[:, j : j + 1]))[:, 0]
        np.testing.assert_allclose(batched[:, j], col, rtol=1e-10, atol=1e-12)


def test_interp_plan_fast_matches_exact(rng):
    """Scatter-free InterpPlan Wᵀ/W == exact scatter/gather forms (f64)."""
    from gp_grief_jax.ops.interp import (
        build_interp_plan,
        interp_matvec_bm,
        interp_matvec_bm_fast,
        interp_rmatvec_bm,
        interp_rmatvec_bm_fast,
        interp_weights,
    )

    n, d, B = 400, 3, 5
    x = jnp.asarray(rng.uniform(0, 3, size=(n, d)))
    xg = tuple(jnp.asarray(np.linspace(0, 3, m))[:, None] for m in (7, 5, 6))
    iw = interp_weights(x, xg)
    plan = build_interp_plan(iw)
    M = 7 * 5 * 6

    v = jnp.asarray(rng.standard_normal((B, n)))
    got = interp_rmatvec_bm_fast(plan, v)
    ref = interp_rmatvec_bm(iw, v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-9, atol=1e-12)

    u = jnp.asarray(rng.standard_normal((B, M)))
    got2 = interp_matvec_bm_fast(plan, u)
    ref2 = interp_matvec_bm(iw, u)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(ref2), rtol=1e-10, atol=1e-12)

    from gp_grief_jax.ops.interp import interp_rmatvec_bm_exact

    got3 = interp_rmatvec_bm_exact(plan, v)
    np.testing.assert_allclose(np.asarray(got3), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_interp_plan_exact_overflow(rng):
    """ELL slot overflow path: max_slots=1 forces most entries through the
    residual scatter — result must still be exact."""
    from gp_grief_jax.ops.interp import (
        build_interp_plan,
        interp_rmatvec_bm,
        interp_rmatvec_bm_exact,
        interp_weights,
    )

    n, d, B = 200, 2, 3
    x = jnp.asarray(rng.uniform(0, 1, size=(n, d)))  # dense occupancy on 4x4
    xg = tuple(jnp.asarray(np.linspace(0, 1, 4))[:, None] for _ in range(d))
    iw = interp_weights(x, xg)
    plan = build_interp_plan(iw, max_slots=1)
    assert int(plan.ov_ids.shape[0]) > 0  # overflow exercised
    v = jnp.asarray(rng.standard_normal((B, n)))
    np.testing.assert_allclose(
        np.asarray(interp_rmatvec_bm_exact(plan, v)),
        np.asarray(interp_rmatvec_bm(iw, v)),
        rtol=1e-12, atol=1e-13,
    )


def test_interp_plan_degenerate_dim(rng):
    """Plan handles m_d = 1 (constant feature) and duplicate points."""
    from gp_grief_jax.ops.interp import (
        build_interp_plan,
        interp_rmatvec_bm,
        interp_rmatvec_bm_fast,
        interp_weights,
    )

    x = jnp.asarray(np.concatenate([rng.uniform(0, 1, size=(30, 2))] * 2))  # dups
    x = x.at[:, 1].set(0.5)  # second dim constant
    xg = (jnp.asarray(np.linspace(0, 1, 6))[:, None], jnp.asarray([[0.5]]))
    iw = interp_weights(x, xg)
    plan = build_interp_plan(iw)
    v = jnp.asarray(rng.standard_normal((2, x.shape[0])))
    np.testing.assert_allclose(
        np.asarray(interp_rmatvec_bm_fast(plan, v)),
        np.asarray(interp_rmatvec_bm(iw, v)),
        rtol=1e-9, atol=1e-12,
    )


def _ski_model(rng, x, shape, **kw):
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(x.shape[0])
    xg = tuple(np.linspace(0, 1, m)[:, None] for m in shape)
    return GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.3), xg, noise_var=0.1,
        precond_rank=0, **kw,
    )


def _check_rmatvec_against_scatter(rng, model):
    from gp_grief_jax.ops.interp import interp_rmatvec_bm

    n = model.x.shape[0]
    u = jnp.asarray(rng.standard_normal((3, n)))
    ref = interp_rmatvec_bm(model.iw, u)
    np.testing.assert_allclose(
        np.asarray(model._rmatvec_bm(u)), np.asarray(ref), rtol=1e-11, atol=1e-13
    )
    # VJP: d/du <Wᵀu, c> = W c, same as differentiating the scatter form.
    c = jnp.asarray(rng.standard_normal(ref.shape))
    g = jax.grad(lambda u: jnp.sum(model._rmatvec_bm(u) * c))(u)
    g_ref = jax.grad(lambda u: jnp.sum(interp_rmatvec_bm(model.iw, u) * c))(u)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize(
    "n,shape,windowed", [(200, (32, 32), False), (400, (6, 6, 6), True)]
)
def test_ski_rmatvec_dispatch_by_fill(rng, n, shape, windowed):
    """Wᵀ takes the flat ELL plan below _WINDOWED_MIN_FILL points per cell
    and the windowed applies above it; both equal the scatter oracle."""
    from gp_grief_jax.models.gp_ski import _WINDOWED_MIN_FILL

    assert (n / np.prod(shape) >= _WINDOWED_MIN_FILL) == windowed
    model = _ski_model(rng, rng.uniform(0, 1, (n, len(shape))), shape)
    assert (model._wplan is not None) == windowed
    _check_rmatvec_against_scatter(rng, model)


def test_ski_rmatvec_ell_overflow_at_low_fill(rng):
    """n ≪ m with 60 coincident points: the ELL plan's overflow stream is
    exercised and Wᵀ (value and VJP) still equals the scatter oracle."""
    x = np.concatenate([np.full((60, 2), 0.37), rng.uniform(0, 1, (40, 2))])
    model = _ski_model(rng, x, (32, 32))
    assert model._wplan is None
    assert int(model._plan.ov_ids.shape[0]) > 0
    _check_rmatvec_against_scatter(rng, model)


def test_gp_ski_onehot_model_nlml(rng):
    """At low fill (n ≪ m) the dispatched flat ELL plan and the windowed
    applies give the same NLML."""
    n = 200
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)
    kw = dict(mbar=16, noise_var=0.2, num_probes=32, lanczos_iters=25, cg_iters=200)
    m1 = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.8), **kw)
    assert m1._wplan is None  # 200 points on 16² cells: the flat ELL plan
    m2 = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.8), **kw)
    m2._wplan = build_windowed_plan(m2.iw)  # force the windowed applies
    assert m2._wplan is not None
    m2._w_ops = make_windowed_ops(m2._wplan)
    l1, l2 = m1.log_likelihood(), m2.log_likelihood()
    assert abs(l1 - l2) / abs(l2) < 1e-7


@pytest.mark.slow
def test_gp_ski_precond_nlml_matches_dense(rng):
    """precond_rank>0: deflated CG + whitened SLQ NLML ≈ the dense-operator
    NLML oracle, and the preconditioned quadratic term matches the dense
    solve (the solution is unchanged by preconditioning, only convergence)."""
    from gp_grief_jax.kernels.grid import cov_grid
    from gp_grief_jax.ops import kron_expand
    from gp_grief_jax.ops.interp import interp_expand

    n = 150
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    sigma2 = 0.2
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg,
        noise_var=sigma2, num_probes=128, lanczos_iters=40, cg_iters=400,
        precond_rank=24,
    )
    factors = cov_grid(m.params["kernels"], m.xg, dim_noise_var=0.0)
    W = np.asarray(interp_expand(m.iw))
    K = np.asarray(kron_expand(factors))
    A = W @ K @ W.T + sigma2 * np.eye(n)
    alpha_d = np.linalg.solve(A, np.asarray(y))
    sign, logdet = np.linalg.slogdet(A)
    assert sign > 0
    nlml_dense = 0.5 * (
        float(np.dot(np.asarray(y), alpha_d)) + logdet + n * np.log(2 * np.pi)
    )

    # Preconditioned CG reaches the dense solution.
    alpha = np.asarray(m._solve(factors, jnp.asarray(sigma2), jnp.asarray(y)))
    np.testing.assert_allclose(alpha, alpha_d, rtol=1e-6, atol=1e-8)
    # Whitened-SLQ NLML close to dense oracle (stochastic logdet residual).
    nlml = -m.log_likelihood()
    assert abs(nlml - nlml_dense) / abs(nlml_dense) < 2e-3


@pytest.mark.slow
def test_gp_ski_mixed_matches_exact_nlml(rng):
    """cg_precision='mixed' (fast-interp inner loop + SLQ) ≈ 'exact' NLML."""
    n = 300
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    kw = dict(mbar=8, noise_var=0.2, num_probes=64, lanczos_iters=30, cg_iters=200)
    me = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.8), **kw, cg_precision="exact")
    mm = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.8), **kw, cg_precision="mixed")
    le, lm = me.log_likelihood(), mm.log_likelihood()
    assert abs(lm - le) / abs(le) < 1e-4


@pytest.mark.slow
def test_ski_lanczos_variance_close_to_exact(rng):
    """LOVE-style variance (variance='lanczos') vs the exact CG variance.

    Full-rank Lanczos spans the whole Krylov space -> matches exact; the
    truncated estimate must over-estimate (Galerkin projection of the
    inverse is dominated by the inverse) and converge with rank.
    """
    n = 300
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.8),
        mbar=8, noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=400,
    )
    xs = rng.uniform(0.2, 2.8, size=(40, 2))
    mu_e, var_e = m.predict(xs, variance="exact")
    mu_l, var_l = m.predict(xs, variance="lanczos", var_rank=n)
    np.testing.assert_allclose(mu_l, mu_e, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(var_l, var_e, rtol=5e-3, atol=1e-6)

    _, var_40 = m.predict(xs, variance="lanczos", var_rank=40)
    assert np.all(var_40 >= var_e - 1e-6)          # over-estimates
    assert np.all(np.isfinite(var_40)) and np.all(var_40 >= 0)
    # rank-40 already captures most of the posterior reduction here
    assert np.mean(np.abs(var_40 - var_e)) < 0.3 * np.mean(var_e) + 1e-6


def test_ski_lattice_lanczos_variance_close_to_exact(rng):
    """Dual LOVE (variance='lanczos' under solver='lattice'): the whitened
    dual's Krylov space is M-dimensional, so full rank (var_rank=M) must
    match the exact dual variance; truncation converges with rank."""
    n = 400
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 3.1, 8)[:, None]] * 2
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.8), xg, solver="lattice",
        noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=400,
        cg_tol=1e-12,
    )
    xs = rng.uniform(0.2, 2.8, size=(40, 2))
    mu_e, var_e = m.predict(xs, variance="exact")
    mu_l, var_l = m.predict(xs, variance="lanczos", var_rank=10**9)  # → M
    np.testing.assert_allclose(mu_l, mu_e, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(var_l, var_e, rtol=5e-3, atol=1e-6)
    _, var_16 = m.predict(xs, variance="lanczos", var_rank=16)
    assert np.all(np.isfinite(var_16)) and np.all(var_16 >= 0)
    # Truncated dual LOVE models the off-span inverse as the identity (the
    # whitened cluster value) — the residual is a small fraction of the
    # PRIOR variance (~1 here), not of the tiny posterior variance.
    assert np.mean(np.abs(var_16 - var_e)) < 0.03


def test_ski_love_guard_warns_on_degraded_variance(rng):
    """Round-3 weak #1: LOVE at a rank too low for the lattice must WARN
    (sampled-column diagnostic vs the exact route); at full rank, or with
    love_check=0, it must stay silent."""
    import warnings

    n = 400
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 3.1, 10)[:, None]] * 2
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.8), xg, solver="lattice",
        noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=400,
        cg_tol=1e-12,
    )
    xs = rng.uniform(0.2, 2.8, size=(30, 2))
    # Severely truncated rank on a posterior whose variances are tiny next to
    # the prior → the identity-tail model is off by far more than 2%.
    with pytest.warns(UserWarning, match="variance='exact'"):
        _, var_degraded = m.predict(
            xs, variance="lanczos", var_rank=3, love_tol=0.02,
            love_on_fail="warn",
        )
    # Round-4 weak #3: the default policy AUTO-UPGRADES to the exact route
    # instead of returning the degraded variances behind a warning.
    with pytest.warns(UserWarning, match="auto-upgrading"):
        mean_up, var_up = m.predict(
            xs, variance="lanczos", var_rank=3, love_tol=0.02,
        )
    mean_e, var_e = m.predict(xs, variance="exact")
    np.testing.assert_allclose(var_up, var_e, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mean_up, mean_e, rtol=1e-5, atol=1e-7)
    assert np.max(np.abs(var_degraded - var_e)) > np.max(
        np.abs(var_up - var_e)
    ), "the warn path must actually have been degraded"
    # Explicit raise policy.
    with pytest.raises(RuntimeError, match="deviates"):
        m.predict(
            xs, variance="lanczos", var_rank=3, love_tol=0.02,
            love_on_fail="raise",
        )
    with pytest.raises(ValueError, match="love_on_fail"):
        m.predict(xs, variance="lanczos", love_on_fail="upgrade")
    # Full rank: exact on the whole M-dim dual space — silent.
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        m.predict(xs, variance="lanczos", var_rank=10**9, love_tol=0.02)
        # guard disabled: silent even at the degraded rank
        m.predict(xs, variance="lanczos", var_rank=3, love_check=0)


@pytest.mark.slow
def test_ski_log_likelihood_segmented_matches_monolithic(rng):
    """Host-segmented NLML (segmented CG + probe-chunked whitened SLQ) agrees
    with the monolithic jitted NLML: identical quadratic form, log-det within
    the whitened-SLQ sampling residual."""
    n = 150
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg,
        noise_var=0.2, num_probes=96, lanczos_iters=30, cg_iters=300,
        precond_rank=24,
    )
    mono = m.log_likelihood()
    seg = m.log_likelihood_segmented(cg_segment_iters=25, probe_chunk=16)
    assert abs(seg - mono) / abs(mono) < 5e-3
    # Unpreconditioned path (precond_rank=0) also runs segmented.
    m0 = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg,
        noise_var=0.5, num_probes=96, lanczos_iters=30, cg_iters=400,
        precond_rank=0,
    )
    seg0 = m0.log_likelihood_segmented(cg_segment_iters=50, probe_chunk=96)
    mono0 = m0.log_likelihood()
    # Unwhitened SLQ: the two paths draw DIFFERENT probe sets (chunk keys),
    # so they agree only within Hutchinson sampling noise (~1% here; the
    # whitened comparison above is tight because deflation kills the
    # estimator variance).
    assert abs(seg0 - mono0) / abs(mono0) < 3e-2


@pytest.mark.slow
def test_ski_segmented_fused_probes_match_unfused(rng):
    """fuse_probes=True (SLQ chunks advancing CG through shared operator
    applies — ops/fused.py) must reproduce the separate-pass segmented NLML:
    identical probe draws and recurrence arithmetic, CG converged either
    way."""
    n = 160
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    for kwargs in (
        dict(precond_rank=24),                     # whitened data-space
        dict(precond_rank=0),                      # unpreconditioned
        dict(solver="lattice"),                    # lattice dual
    ):
        m = GPSKIRegression(
            x, y, make_kernel("rbf", lengthscale=0.6), xg,
            noise_var=0.2, num_probes=32, lanczos_iters=25, cg_iters=300,
            **kwargs,
        )
        unf = m.log_likelihood_segmented(
            cg_segment_iters=25, probe_chunk=16, fuse_probes=False
        )
        fus = m.log_likelihood_segmented(
            cg_segment_iters=25, probe_chunk=16, fuse_probes=True
        )
        assert abs(fus - unf) / abs(unf) < 1e-8


def test_ski_segmented_nlml_programs_cached(rng):
    """Repeated segmented NLML evaluations reuse the compile-once program set
    (no per-call rebuild — the rebuild cost ~15 s of host time per 1M-point
    evaluation) and return the identical value; changing
    the segment geometry rebuilds."""
    n = 120
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    for kwargs in (
        dict(precond_rank=16),                      # whitened data-space
        dict(precond_rank=0),                       # unpreconditioned
    ):
        m = GPSKIRegression(
            x, y, make_kernel("rbf", lengthscale=0.6), xg,
            noise_var=0.2, num_probes=32, lanczos_iters=20, cg_iters=200,
            **kwargs,
        )
        v1 = m.log_likelihood_segmented(cg_segment_iters=25, probe_chunk=8)
        progs = m._nlml_progs
        v2 = m.log_likelihood_segmented(cg_segment_iters=25, probe_chunk=8)
        assert m._nlml_progs is progs          # cache hit: same program set
        assert v2 == v1                        # deterministic draw → identical
        m.log_likelihood_segmented(cg_segment_iters=50, probe_chunk=8)
        assert m._nlml_progs is not progs      # geometry change → rebuild


def test_ski_lattice_stencil_matches_windowed_path(rng):
    """The WᵀW stencil fusion (wtw_stencil=True, the default) must reproduce
    the point-space composition's solves and NLML (same operator, fused)."""
    n = 250
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    kw = dict(noise_var=0.2, num_probes=8, lanczos_iters=30, cg_iters=500,
              cg_tol=1e-12, solver="lattice")
    ms = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg, **kw)
    mw = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg,
                         wtw_stencil=False, **kw)
    assert ms._wtw_op is not None and mw._wtw_op is None
    from gp_grief_jax.kernels.grid import cov_grid

    factors = cov_grid(ms.params["kernels"], ms.xg, dim_noise_var=0.0)
    s_s = np.asarray(ms._solve(factors, jnp.asarray(0.2), jnp.asarray(y)))
    s_w = np.asarray(mw._solve(factors, jnp.asarray(0.2), jnp.asarray(y)))
    np.testing.assert_allclose(s_s, s_w, rtol=1e-7, atol=1e-9)
    ll_s = ms.log_likelihood()
    ll_w = mw.log_likelihood()
    assert abs(ll_s - ll_w) / abs(ll_w) < 1e-5


@pytest.mark.slow
def test_ski_lattice_solver_matches_dense(rng):
    """solver='lattice' (Woodbury dual on the whitened lattice operator):
    the data-space solve must equal the dense solve to solver precision, and
    the NLML must match the dense oracle within whitened-SLQ sampling noise,
    in BOTH the n>m and n<m regimes."""
    from gp_grief_jax.kernels.grid import cov_grid
    from gp_grief_jax.ops import kron_expand
    from gp_grief_jax.ops.interp import interp_expand

    for n, mg, ll_tol in ((300, 8, 5e-3), (40, 10, 3e-2)):
        x = rng.uniform(0, 2, size=(n, 2))
        y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
        xg = [np.linspace(-0.1, 2.1, mg)[:, None]] * 2
        m = GPSKIRegression(
            x, y, make_kernel("rbf", lengthscale=0.6), xg, solver="lattice",
            noise_var=0.2, num_probes=256, lanczos_iters=60, cg_iters=600,
            cg_tol=1e-12,
        )
        factors = cov_grid(m.params["kernels"], m.xg, dim_noise_var=0.0)
        W = np.asarray(interp_expand(m.iw))
        K = np.asarray(kron_expand(factors))
        A = W @ K @ W.T + 0.2 * np.eye(n)
        sol = np.asarray(m._solve(factors, jnp.asarray(0.2), jnp.asarray(y)))
        want = np.linalg.solve(A, y)
        np.testing.assert_allclose(sol, want, rtol=1e-8, atol=1e-10)
        sign, ld = np.linalg.slogdet(A)
        assert sign > 0
        nlml_dense = 0.5 * (y @ want + ld + n * np.log(2 * np.pi))
        ll = m.log_likelihood()
        assert abs(ll + nlml_dense) / abs(nlml_dense) < ll_tol
        # Gradients flow through the dual (closed-form terms exact,
        # log|whitened| via the Hutchinson surrogate).
        g = jax.grad(m._loss)(m.params)
        from jax.flatten_util import ravel_pytree

        gv = np.asarray(ravel_pytree(g)[0])
        assert np.all(np.isfinite(gv)) and np.linalg.norm(gv) > 0
        # Segmented variant agrees within the probe-partitioning noise.
        seg = m.log_likelihood_segmented(cg_segment_iters=40, probe_chunk=64)
        assert abs(seg - ll) / abs(ll) < ll_tol


def test_ski_lattice_predict_matches_data_solver(rng):
    """predict() under solver='lattice' == solver='data' (same posterior)."""
    n = 200
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    kw = dict(noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=500,
              cg_tol=1e-12)
    md = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg,
                         solver="data", precond_rank=64, **kw)
    ml = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg,
                         solver="lattice", **kw)
    xs = rng.uniform(0.1, 1.9, size=(33, 2))
    mean_d, var_d = md.predict(xs)
    mean_l, var_l = ml.predict(xs)
    np.testing.assert_allclose(mean_l, mean_d, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(var_l, var_d, rtol=1e-6, atol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("solver", ["data", "lattice"])
def test_ski_optimize_segmented_matches_monolithic_step(rng, solver):
    """One optimize_segmented step == one Adam step on jax.grad(_loss) when
    the probe draws are aligned (the surrogate program's gradient is the
    same BBMM estimator; the SLQ value carries no gradient)."""
    import optax

    n = 160
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    R = 4
    kw = dict(noise_var=0.3, num_probes=R, lanczos_iters=30, cg_iters=400,
              cg_tol=1e-12, solver=solver, precond_rank=24)
    lr = 0.05
    m1 = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg, **kw)
    res = m1.optimize_segmented(max_iters=1, learning_rate=lr, num_probes=R)
    assert np.isfinite(res.losses).all()

    m2 = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg, **kw)
    # Align m2's _loss probe draw with the step's (fold_in(key, 1000 + 0)).
    m2._key = jax.random.fold_in(m2._key, 1000)
    g = jax.grad(m2._loss)(m2.params)
    opt = optax.adam(lr)
    updates, _ = opt.update(g, opt.init(m2.params), m2.params)
    p2 = optax.apply_updates(m2.params, updates)

    from jax.flatten_util import ravel_pytree

    v1 = np.asarray(ravel_pytree(m1.params)[0])
    v2 = np.asarray(ravel_pytree(p2)[0])
    np.testing.assert_allclose(v1, v2, rtol=1e-5, atol=1e-7)


def test_ski_optimize_segmented_improves(rng):
    """A few segmented training steps raise the true NLML."""
    n = 200
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 7)[:, None]] * 2
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=1.2), xg, noise_var=0.5,
        num_probes=16, lanczos_iters=30, cg_iters=300, cg_tol=1e-10,
        precond_rank=32,
    )
    ll0 = m.log_likelihood()
    m.optimize_segmented(max_iters=12, learning_rate=0.1, num_probes=8)
    assert m.log_likelihood() > ll0


def test_ski_lattice_ops_accept_bf16_state(rng):
    """ops/cg.py's ``state_dtype`` contract hands operators their input in
    the (narrow) state dtype.  The lattice ops must then keep every Kron
    factor's dtype matched to the CONTRACTED vector's promoted dtype —
    from_dual's batch-eye following the raw bf16 input while the v·wjs
    product promotes to f32 must still contract with a matching factor."""
    import jax.numpy as jnp

    from gp_grief_jax.kernels.grid import cov_grid

    n = 300
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    m = GPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.8), xg, solver="lattice",
        noise_var=0.2,
    )
    sigma2 = jnp.exp(m.params["log_noise"])
    factors = cov_grid(m.params["kernels"], m.xg, dim_noise_var=m.dim_noise_var)
    Qs, wjs, _ = m._lattice_spectra(factors, sigma2)
    _, _, white = m._make_lattice_ops(Qs, wjs)
    v = jnp.asarray(rng.standard_normal((2, 64)), wjs.dtype)
    ref = white(v)
    out = white(v.astype(jnp.bfloat16))
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=0, atol=2e-2
    )


def test_ski_optimize_segmented_mixed16_lattice(rng):
    """``train_mixed16`` (bf16 CG state + bf16 matvec inputs in the lattice
    dual's TRAINING solves) must train to
    the same neighborhood as the f32 step solves: same probe draws, so the
    only delta is the ~3e-3 solve floor, far below Adam's step scale."""
    n = 400
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 7)[:, None]] * 2

    def train(mixed):
        m = GPSKIRegression(
            x, y, make_kernel("rbf", lengthscale=1.2), xg, noise_var=0.5,
            solver="lattice", num_probes=8, lanczos_iters=30, cg_iters=300,
            train_mixed16=mixed,
        )
        ll0 = m.log_likelihood()
        m.optimize_segmented(max_iters=10, learning_rate=0.1, num_probes=8)
        return ll0, m.log_likelihood(), m

    ll0, ll_f32, _ = train(False)
    _, ll_bf16, _ = train(True)
    assert ll_bf16 > ll0  # training still improves the true NLML
    # and lands within a tight relative band of the f32-trained NLML
    assert abs(float(ll_bf16) - float(ll_f32)) <= 0.02 * abs(float(ll_f32))


def test_lattice_small_n_guard_single_and_sharded(rng):
    """The n << m lattice-dual warning fires from BOTH the single-chip and
    the sharded constructors (shared helper: models/gp_ski.py:
    warn_lattice_small_n — capability parity), and stays
    silent at n >= m/4."""
    import warnings

    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 30
    x = rng.uniform(0, 1, size=(n, 2)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    xg = [np.linspace(-0.1, 1.1, 16)[:, None].astype(np.float32)] * 2  # m=256 >> 4n
    kern = make_kernel("rbf", lengthscale=0.5)
    with pytest.warns(UserWarning, match="lattice.*n << m|n << m"):
        GPSKIRegression(x, y, kern, xg, solver="lattice")
    with pytest.warns(UserWarning, match="lattice.*n << m|n << m"):
        ShardedGPSKIRegression(x, y, kern, xg, solver="lattice")
    # n >= m/4: silent (both constructors).
    xg_small = [np.linspace(-0.1, 1.1, 5)[:, None].astype(np.float32)] * 2  # m=25
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        GPSKIRegression(x, y, kern, xg_small, solver="lattice")
        ShardedGPSKIRegression(x, y, kern, xg_small, solver="lattice")
