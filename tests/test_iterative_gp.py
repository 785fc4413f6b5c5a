"""Iterative (CG + SLQ) exact-GP NLML path vs the Cholesky path."""

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax import make_kernel
from gp_grief_jax.models.gp_regression import gp_nlml, gp_nlml_iterative


def test_iterative_nlml_close_to_exact(rng):
    n = 300
    x = jnp.asarray(rng.uniform(0, 3, size=(n, 2)))
    y = jnp.asarray(np.sin(2 * np.asarray(x)[:, 0]) + 0.1 * rng.standard_normal(n))
    kern = make_kernel("rbf", lengthscale=0.7, variance=1.2)
    log_noise = jnp.log(0.05)

    exact = float(gp_nlml(kern, log_noise, x, y))
    approx = float(
        gp_nlml_iterative(
            kern, log_noise, x, y,
            key=jax.random.PRNGKey(1), num_probes=64, lanczos_iters=60,
        )
    )
    # The quadratic term is CG-exact; only the SLQ log-det is stochastic
    # (absolute error scales with tr|log|, a few nats at n=300).
    assert abs(approx - exact) < 6.0


def test_gp_regression_iterative_solver_model(rng):
    from gp_grief_jax import GPRegression

    n = 250
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    exact = GPRegression(x, y, make_kernel("rbf", lengthscale=0.7), noise_var=0.05)
    it = GPRegression(
        x, y, make_kernel("rbf", lengthscale=0.7), noise_var=0.05,
        solver="iterative", num_probes=64, lanczos_iters=50,
    )
    # SLQ absolute error scales with tr|log| magnitude, not the (near-zero)
    # NLML total; allow a few nats on n=250.
    assert abs(it.log_likelihood() - exact.log_likelihood()) < 5.0
    # Optimization with the stochastic objective still improves the exact NLML.
    ll0 = exact.log_likelihood()
    it.optimize(optimizer="adam", max_iters=30, learning_rate=0.05)
    exact.params = it.params
    assert exact.log_likelihood() > ll0 - 1.0


def test_iterative_gradients_match_exact(rng):
    # BBMM surrogate gradients ≈ exact gradients (stochastic only via the
    # Hutchinson trace; CG terms are exact).
    n = 200
    x = jnp.asarray(rng.uniform(0, 3, size=(n, 2)))
    y = jnp.asarray(np.sin(2 * np.asarray(x)[:, 0]) + 0.1 * rng.standard_normal(n))
    kern = make_kernel("rbf", lengthscale=0.8)

    def f_exact(params):
        return gp_nlml(params[0], params[1], x, y)

    def f_iter(params):
        return gp_nlml_iterative(
            params[0], params[1], x, y,
            key=jax.random.PRNGKey(3), num_probes=256, lanczos_iters=50,
        )

    params = (kern, jnp.log(0.05))
    g_ex = jax.grad(f_exact)(params)
    g_it = jax.grad(f_iter)(params)
    np.testing.assert_allclose(float(g_it[1]), float(g_ex[1]), rtol=0.1)
    np.testing.assert_allclose(
        float(g_it[0].log_lengthscale), float(g_ex[0].log_lengthscale), rtol=0.1
    )
    np.testing.assert_allclose(
        float(g_it[0].log_variance), float(g_ex[0].log_variance), rtol=0.15
    )


def test_grief_iterative_preconditioned(rng):
    """GRIEF iterative NLML with rank-r deflation (preconditioned CG +
    preconditioned SLQ) must match the closed form far tighter than the
    unpreconditioned estimator at the same probe/Lanczos budget."""
    import gp_grief_jax as gpx

    n = 600
    x = rng.uniform(0, 4, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    grid = gpx.InducingGrid.build(x, mbar=12)
    model = gpx.GPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.8) for _ in range(2)],
        grid, n_eigs=60, noise_var=0.05,
    )
    model.optimize(max_iters=40)
    ll_closed = model.log_likelihood()
    budget = dict(num_probes=8, lanczos_iters=20, cg_tol=1e-10, cg_iters=400)
    ll_plain = model.log_likelihood_iterative(**budget)
    ll_prec = model.log_likelihood_iterative(precond_rank=50, **budget)
    gap_plain = abs(ll_plain - ll_closed) / abs(ll_closed)
    gap_prec = abs(ll_prec - ll_closed) / abs(ll_closed)
    assert gap_prec < 1e-4
    assert gap_prec < gap_plain
    # full-rank deflation: whitened operator == I, SLQ contributes ~0 -> exact
    ll_full = model.log_likelihood_iterative(precond_rank=60, **budget)
    np.testing.assert_allclose(ll_full, ll_closed, rtol=1e-5)


def test_gp_regression_iterative_preconditioned(rng):
    """Dense iterative NLML with the pivoted-Cholesky preconditioner
    (preconditioned CG + whitened SLQ) must beat the unpreconditioned
    estimator at the same small probe/Lanczos budget, and approach the
    Cholesky NLML when the rank captures the kernel's numerical rank."""
    n = 300
    x = jnp.asarray(rng.uniform(0, 3, size=(n, 2)))
    y = jnp.asarray(np.sin(2 * np.asarray(x)[:, 0]) + 0.05 * rng.standard_normal(n))
    kern = make_kernel("rbf", lengthscale=0.9)
    log_noise = jnp.log(1e-3)  # small noise -> large kappa: SLQ needs help

    exact = float(gp_nlml(kern, log_noise, x, y))
    budget = dict(key=jax.random.PRNGKey(2), num_probes=8, lanczos_iters=15,
                  cg_tol=1e-10, cg_iters=600)
    plain = float(gp_nlml_iterative(kern, log_noise, x, y, **budget))
    prec = float(gp_nlml_iterative(
        kern, log_noise, x, y, precond_rank=120, **budget))
    assert abs(prec - exact) < abs(plain - exact), (plain, prec, exact)
    assert abs(prec - exact) / abs(exact) < 1e-3, (prec, exact)

    # gradients still flow (BBMM surrogates; preconditioner is value-only)
    g = jax.grad(
        lambda ln: gp_nlml_iterative(
            kern, ln, x, y, precond_rank=60, **budget)
    )(log_noise)
    assert np.isfinite(float(g))


def test_pivoted_cholesky_matfree_matches_dense(rng):
    """Row-access pivoted Cholesky (the matrix-free exact-GP preconditioner
    build) is the SAME greedy factorization as the dense one."""
    from gp_grief_jax.ops.precond import pivoted_cholesky, pivoted_cholesky_matfree

    n, r = 60, 20
    A = rng.standard_normal((n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    Ld = pivoted_cholesky(K, r)
    Lm = pivoted_cholesky_matfree(lambda i: K[:, i], jnp.diagonal(K), r)
    np.testing.assert_allclose(np.asarray(Lm), np.asarray(Ld), rtol=1e-10, atol=1e-10)


def test_iterative_nlml_matrix_free_matches_dense(rng):
    """matvec_chunk > 0 (no (n,n) Gram ever) must reproduce the dense
    iterative NLML and its gradients — same estimator, same probes, only the
    matvec is row-chunked (round-3 missing #2)."""
    n = 300
    x = jnp.asarray(rng.uniform(0, 3, size=(n, 2)))
    y = jnp.asarray(np.sin(2 * np.asarray(x)[:, 0]) + 0.05 * rng.standard_normal(n))
    kern = make_kernel("rbf", lengthscale=0.8)
    log_noise = jnp.log(0.05)
    budget = dict(key=jax.random.PRNGKey(5), num_probes=16, lanczos_iters=25,
                  cg_tol=1e-10, cg_iters=400)
    dense = float(gp_nlml_iterative(kern, log_noise, x, y, **budget))
    chunked = float(gp_nlml_iterative(kern, log_noise, x, y, matvec_chunk=64, **budget))
    np.testing.assert_allclose(chunked, dense, rtol=1e-5)
    # preconditioned too (matfree pivoted-Cholesky build)
    dense_p = float(gp_nlml_iterative(kern, log_noise, x, y, precond_rank=80, **budget))
    chunk_p = float(gp_nlml_iterative(
        kern, log_noise, x, y, precond_rank=80, matvec_chunk=64, **budget))
    np.testing.assert_allclose(chunk_p, dense_p, rtol=1e-5)
    # gradients flow through the scan-rebuilt Gram blocks
    g = jax.grad(
        lambda ln: gp_nlml_iterative(
            kern, ln, x, y, matvec_chunk=64, precond_rank=40, **budget)
    )(log_noise)
    g_dense = jax.grad(
        lambda ln: gp_nlml_iterative(
            kern, ln, x, y, precond_rank=40, **budget)
    )(log_noise)
    np.testing.assert_allclose(float(g), float(g_dense), rtol=1e-4)


def test_gp_regression_matrix_free_model_end_to_end(rng):
    """GPRegression with the matrix-free operator forced: NLML ≈ Cholesky,
    segmented NLML ≈ monolithic, predict ≈ the Cholesky predict — while no
    (n, n) Gram is ever built."""
    from gp_grief_jax import GPRegression

    n = 400
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    kern = make_kernel("rbf", lengthscale=0.8)
    chol = GPRegression(x, y, kern, noise_var=0.05)
    it = GPRegression(
        x, y, kern, noise_var=0.05, solver="iterative",
        num_probes=64, lanczos_iters=40, cg_tol=1e-10, cg_iters=600,
        precond_rank=150, matvec_chunk=128,
    )
    # whitened SLQ with a near-complete preconditioner: tight agreement
    assert abs(it.log_likelihood() - chol.log_likelihood()) < 1.0
    seg = it.log_likelihood_iterative_segmented(cg_segment_iters=25, probe_chunk=16)
    np.testing.assert_allclose(seg, it.log_likelihood(), atol=0.5)
    xs = rng.uniform(0.2, 2.8, size=(37, 2))
    mu_c, var_c = chol.predict(xs)
    mu_i, var_i = it.predict(xs, chunk=16)  # pads 37 -> 48, multi-chunk
    np.testing.assert_allclose(mu_i, mu_c, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(var_i, var_c, rtol=1e-3, atol=1e-7)


def test_gp_regression_matrix_free_predict_cache(rng):
    """The representer solve is cached per hyperparameter values: repeat
    predicts reuse it; a params change invalidates it (results track the
    new hypers, not the stale cache)."""
    from gp_grief_jax import GPRegression

    n = 200
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(2 * x[:, 0]) + 0.05 * rng.standard_normal(n)
    kern = make_kernel("rbf", lengthscale=0.8)
    it = GPRegression(
        x, y, kern, noise_var=0.05, solver="iterative",
        cg_tol=1e-10, cg_iters=400, precond_rank=60, matvec_chunk=64,
    )
    xs = rng.uniform(0.3, 2.7, size=(11, 2))
    m1, v1 = it.predict(xs)
    a_cached = it._pred_cache[2]
    m2, v2 = it.predict(xs)
    assert it._pred_cache[2] is a_cached  # reused, not recomputed
    np.testing.assert_array_equal(m1, m2)
    # hyperparameter change invalidates the cache
    it.params = dict(it.params, log_noise=jnp.log(0.5))
    m3, _ = it.predict(xs)
    assert it._pred_cache[2] is not a_cached
    chol = GPRegression(x, y, kern, noise_var=0.5)
    mc, _ = chol.predict(xs)
    np.testing.assert_allclose(m3, mc, rtol=1e-5, atol=1e-7)


def test_grief_iterative_segmented_matches_monolithic(rng):
    """Host-segmented GRIEF iterative NLML (segmented CG + probe-chunked
    SLQ — the uci2m segmented evaluator) agrees with the monolithic
    jitted path: identical CG recurrence; whitened log-det within quadrature
    accuracy when the deflation rank covers the spectrum, within Hutchinson
    noise unwhitened (mirrors test_ski_log_likelihood_segmented_matches_
    monolithic)."""
    import gp_grief_jax as gpx

    n = 500
    x = rng.uniform(0, 4, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(n)
    grid = gpx.InducingGrid.build(x, mbar=10)
    model = gpx.GPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.8) for _ in range(2)],
        grid, n_eigs=50, noise_var=0.1,
    )
    model.optimize(max_iters=30)
    ll_closed = model.log_likelihood()
    budget = dict(num_probes=16, lanczos_iters=20, cg_tol=1e-10, cg_iters=200)
    # Full-rank whitening: the whitened operator is exactly I, SLQ is
    # probe-independent -> segmented must match both monolithic and closed.
    seg_full = model.log_likelihood_iterative_segmented(
        precond_rank=50, cg_segment_iters=25, probe_chunk=4, **budget
    )
    np.testing.assert_allclose(seg_full, ll_closed, rtol=1e-5)
    mono_full = model.log_likelihood_iterative(precond_rank=50, **budget)
    np.testing.assert_allclose(seg_full, mono_full, rtol=1e-5)
    # Unpreconditioned: different probe partitioning (fold_in per chunk) ->
    # agreement within SLQ sampling noise only.
    seg0 = model.log_likelihood_iterative_segmented(
        cg_segment_iters=50, probe_chunk=16, **budget
    )
    mono0 = model.log_likelihood_iterative(**budget)
    assert abs(seg0 - mono0) / abs(mono0) < 3e-2, (seg0, mono0)
    # Fused probes share the operator applications but draw the SAME probe
    # family (fold_in(key, chunk)) — fused == separate-pass segmented to
    # solver/quadrature precision.
    seg_sep = model.log_likelihood_iterative_segmented(
        precond_rank=50, cg_segment_iters=25, probe_chunk=4,
        fuse_probes=False, **budget
    )
    np.testing.assert_allclose(seg_full, seg_sep, rtol=1e-5)
    seg0_sep = model.log_likelihood_iterative_segmented(
        cg_segment_iters=50, probe_chunk=16, fuse_probes=False, **budget
    )
    np.testing.assert_allclose(seg0, seg0_sep, rtol=1e-4)


def test_gp_regression_mixed16_segmented_nlml_parity(rng):
    """mixed16=True (low-precision inner CG under exact-residual refinement) must
    agree with the plain f32 segmented NLML: only the SOLVER's inner
    operating point changes, never the estimator."""
    from gp_grief_jax import GPRegression, make_kernel

    n = 600
    x = rng.uniform(0, 4, size=(n, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.cos(x[:, 1])
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(noise_var=0.05, solver="iterative", matvec_chunk=128)
    m_mixed = GPRegression(
        x, y, make_kernel("rbf", lengthscale=0.7, input_dim=2),
        mixed16=True, **kw,
    )
    m_plain = GPRegression(
        x, y, make_kernel("rbf", lengthscale=0.7, input_dim=2), **kw,
    )
    ll_m = m_mixed.log_likelihood_iterative_segmented()
    ll_p = m_plain.log_likelihood_iterative_segmented()
    assert abs(ll_m - ll_p) < 1e-3 * abs(ll_p), (ll_m, ll_p)
    # The differentiable loss path (fit()'s objective) accepts mixed16 too.
    v_m = float(m_mixed._loss(m_mixed.params))
    v_p = float(m_plain._loss(m_plain.params))
    assert abs(v_m - v_p) < 1e-2 * abs(v_p), (v_m, v_p)


def test_mixed16_grad_compiles_without_on2_slab_stack(rng):
    """value_and_grad of the matrix-free iterative loss must NOT materialize
    the stacked (nb, n, chunk) Gram-slab buffer.  Round-5 regression: any
    path that lets the solver loops be linearized (custom_linear_solve's
    linear-function partial-eval, or solver operators closing over LIVE
    params) hoists every per-block slab into one stacked constant — a 64 GB
    compile-time allocation at n=2**17 on the chip.  The fix: solves run on
    stop-gradient operators (they are value-only by design; BBMM surrogates
    carry the gradient).  Checked structurally on the optimized HLO."""
    import re

    from gp_grief_jax import GPRegression, make_kernel

    n, chunk = 1024, 256
    x = rng.uniform(0, 4, size=(n, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(
        noise_var=0.05, solver="iterative", matvec_chunk=chunk,
        precond_rank=16, num_probes=8, lanczos_iters=8, cg_iters=40,
        cg_tol=1e-6,
    )
    m = GPRegression(
        x, y, make_kernel("rbf", lengthscale=0.8, input_dim=2),
        mixed16=True, **kw,
    )
    txt = (
        jax.jit(jax.value_and_grad(m._loss)).lower(m.params).compile().as_text()
    )
    nb = n // chunk
    pat = re.compile(
        rf"\[({nb},{n},{chunk}|{nb},{chunk},{n}|{n},{n})\]"
    )
    hits = sorted({mm.group(0) for mm in pat.finditer(txt)})
    assert not hits, f"O(n^2) buffers in compiled grad program: {hits}"

    # And the gradient itself must agree with the plain-f32 loss's gradient
    # (same estimator, same probe key; only the inner solver precision
    # differs and both converge to cg_tol).
    m_plain = GPRegression(
        x, y, make_kernel("rbf", lengthscale=0.8, input_dim=2), **kw,
    )
    v16, g16 = jax.value_and_grad(m._loss)(m.params)
    v32, g32 = jax.value_and_grad(m_plain._loss)(m_plain.params)
    assert np.isfinite(float(v16)) and abs(v16 - v32) < 1e-2 * abs(v32)
    flat16 = jnp.concatenate([jnp.ravel(l) for l in jax.tree.leaves(g16)])
    flat32 = jnp.concatenate([jnp.ravel(l) for l in jax.tree.leaves(g32)])
    np.testing.assert_allclose(
        np.asarray(flat16), np.asarray(flat32), rtol=2e-2, atol=2e-4
    )


def test_segmented_nlml_fused_matches_separate(rng):
    """fuse_probes=True (round-5 default) must match the separate-pass
    CG + SLQ estimator: same probe draws, same quadrature family — only the
    program partitioning differs (fused shares operator applications)."""
    from gp_grief_jax import GPRegression, make_kernel

    n = 800
    x = rng.uniform(0, 4, size=(n, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    for pr in (0, 32):
        m = GPRegression(
            x, y, make_kernel("rbf", lengthscale=0.6, input_dim=2),
            noise_var=0.05, solver="iterative", matvec_chunk=256,
            precond_rank=pr, num_probes=12, lanczos_iters=12,
            cg_tol=1e-7, cg_iters=100,
        )
        ll_fused = m.log_likelihood_iterative_segmented(fuse_probes=True)
        ll_sep = m.log_likelihood_iterative_segmented(fuse_probes=False)
        assert abs(ll_fused - ll_sep) < 3e-3 * abs(ll_sep), (pr, ll_fused, ll_sep)
        # Iteration-segmented fused partitioning is estimator-identical too.
        ll_itseg = m.log_likelihood_iterative_segmented(
            fuse_probes=True, slq_iter_segment=5
        )
        assert abs(ll_itseg - ll_fused) < 1e-5 * abs(ll_fused), (pr, ll_itseg, ll_fused)


def test_optimize_segmented_matches_monolithic(rng):
    """optimize_segmented (round-5: bounded-program training for matrix-free
    scales) must track the monolithic differentiable loss: same SAA probes,
    same BBMM surrogate gradient — only the program decomposition differs."""
    from gp_grief_jax import GPRegression, make_kernel

    n = 1200
    x = rng.uniform(0, 4, size=(n, 2)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(noise_var=0.3, solver="iterative", matvec_chunk=256,
              precond_rank=16, num_probes=8, lanczos_iters=10,
              cg_tol=1e-7, cg_iters=80)
    kern = lambda: make_kernel("rbf", lengthscale=0.9, input_dim=2)  # noqa: E731
    m_seg = GPRegression(x, y, kern(), **kw)
    m_mono = GPRegression(x, y, kern(), **kw)
    res = m_seg.optimize_segmented(max_iters=5, learning_rate=0.05)
    m_mono.optimize(max_iters=5, optimizer="adam", learning_rate=0.05,
                    scan_chunk=1, tol=0.0)
    assert abs(m_seg.noise_var - m_mono.noise_var) < 1e-6 * m_mono.noise_var
    ls_s = np.asarray(jnp.exp(m_seg.params["kernel"].log_lengthscale))
    ls_m = np.asarray(jnp.exp(m_mono.params["kernel"].log_lengthscale))
    np.testing.assert_allclose(ls_s, ls_m, rtol=1e-5)
    assert np.all(np.isfinite(res.losses)) and res.iterations == 5
    # guard: dense/small-n configs must be told to use optimize()
    import pytest

    m_dense = GPRegression(x, y, kern(), noise_var=0.3, solver="iterative")
    with pytest.raises(ValueError):
        m_dense.optimize_segmented(max_iters=1)
