"""CG / Lanczos / SLQ tests against dense oracles, including gradient flow
through the CG solve (the BBMM-style implicit adjoint)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.ops import (
    cg_solve,
    kron_eigh,
    kron_expand,
    kron_matvec,
    lanczos,
    logdet_from_chol,
    slq_logdet,
    solve_chol,
    stable_cholesky,
)


def _spd(rng, n, cond=10.0):
    A = rng.standard_normal((n, n))
    A = A @ A.T
    return A + (np.trace(A) / n / cond) * np.eye(n)


def test_cg_matches_dense(rng):
    n = 40
    A = jnp.asarray(_spd(rng, n))
    b = jnp.asarray(rng.standard_normal(n))
    x = cg_solve(lambda v: A @ v, b, tol=1e-12, max_iters=200)
    np.testing.assert_allclose(x, np.linalg.solve(np.asarray(A), np.asarray(b)), rtol=1e-7)


def test_cg_batched_and_info(rng):
    n, B = 30, 4
    A = jnp.asarray(_spd(rng, n))
    rhs = jnp.asarray(rng.standard_normal((n, B)))
    x, info = cg_solve(lambda v: A @ v, rhs, tol=1e-12, max_iters=200, return_info=True)
    np.testing.assert_allclose(x, np.linalg.solve(np.asarray(A), np.asarray(rhs)), rtol=1e-7)
    assert int(info.iterations) <= 200
    assert np.all(np.asarray(info.residual_norm) < 1e-8)


def test_cg_preconditioned_converges_faster(rng):
    n = 60
    A_np = _spd(rng, n, cond=1e4)
    A = jnp.asarray(A_np)
    d = jnp.asarray(np.diag(A_np))
    b = jnp.asarray(rng.standard_normal(n))
    _, info_plain = cg_solve(lambda v: A @ v, b, tol=1e-10, max_iters=500, return_info=True)
    _, info_prec = cg_solve(
        lambda v: A @ v, b, tol=1e-10, max_iters=500,
        M_inv=lambda r: r / d[:, None], return_info=True,
    )
    assert int(info_prec.iterations) <= int(info_plain.iterations)


def test_cg_gradient_implicit(rng):
    # d/dtheta of bᵀ(A + theta I)⁻¹ b must match the dense formula; gradients
    # flow through parameters captured in the matvec closure.
    n = 20
    A = jnp.asarray(_spd(rng, n))
    b = jnp.asarray(rng.standard_normal(n))

    def f(theta):
        x = cg_solve(lambda v: A @ v + theta * v, b, tol=1e-13, max_iters=200)
        return jnp.dot(b, x)

    theta0 = 0.5
    g = jax.grad(f)(theta0)
    Ainv_b = np.linalg.solve(np.asarray(A) + theta0 * np.eye(n), np.asarray(b))
    ref = -Ainv_b @ Ainv_b
    np.testing.assert_allclose(g, ref, rtol=1e-6)


def test_cg_with_kron_matvec(rng):
    # The 3D-grid config (BASELINE.json config 2): CG on (⊗K_d + σ²I).
    def spd(n):
        M = rng.standard_normal((n, n))
        return jnp.asarray(M @ M.T + n * np.eye(n))

    factors = (spd(3), spd(4), spd(5))
    sigma2 = 0.3
    K = np.asarray(kron_expand(factors))
    b = jnp.asarray(rng.standard_normal(K.shape[0]))
    x = cg_solve(
        lambda v: kron_matvec(factors, v) + sigma2 * v, b, tol=1e-12, max_iters=300
    )
    ref = np.linalg.solve(K + sigma2 * np.eye(K.shape[0]), np.asarray(b))
    np.testing.assert_allclose(x, ref, rtol=1e-6)


def test_lanczos_tridiagonalizes(rng):
    n, k = 30, 12
    A = jnp.asarray(_spd(rng, n))
    v0 = jnp.asarray(rng.standard_normal(n))
    res = lanczos(lambda v: A @ v, v0, k)
    Q = np.asarray(res.Q)
    # Orthonormal basis and Qᵀ A Q = T.
    np.testing.assert_allclose(Q.T @ Q, np.eye(k), atol=1e-9)
    T = np.diag(np.asarray(res.alpha)) + np.diag(np.asarray(res.beta), 1) + np.diag(
        np.asarray(res.beta), -1
    )
    np.testing.assert_allclose(Q.T @ np.asarray(A) @ Q, T, atol=1e-8)
    assert int(res.num_valid) == k


def test_lanczos_breakdown_masked(rng):
    # Rank-deficient operator: Krylov space is exhausted early; past-breakdown
    # slots must be zero, shapes static.
    n, k, r = 20, 15, 4
    U = rng.standard_normal((n, r))
    A = jnp.asarray(U @ U.T)
    v0 = jnp.asarray(rng.standard_normal(n))
    res = lanczos(lambda v: A @ v, v0, k)
    nv = int(res.num_valid)
    # Krylov dimension is r+1 (range directions + null component); allow one
    # extra noise-level iteration around the breakdown threshold.
    assert nv <= r + 2
    assert nv < k
    assert np.all(np.asarray(res.alpha)[nv:] == 0)
    assert np.all(np.asarray(res.beta)[nv - 1 :] == 0)


def test_slq_logdet(rng):
    n = 100
    A_np = _spd(rng, n)
    A = jnp.asarray(A_np)
    ref = np.linalg.slogdet(A_np)[1]
    est = slq_logdet(
        lambda v: A @ v,
        n,
        key=jax.random.PRNGKey(0),
        num_probes=64,
        lanczos_iters=30,
        dtype=jnp.float64,
        full_reorth=True,
    )
    # Stochastic estimator: a few percent relative accuracy.
    np.testing.assert_allclose(float(est), ref, rtol=0.05)


def test_stable_cholesky_and_solve(rng):
    n = 10
    A_np = _spd(rng, n)
    L, used = stable_cholesky(jnp.asarray(A_np))
    assert float(used) == 0.0
    b = rng.standard_normal(n)
    np.testing.assert_allclose(
        solve_chol(L, jnp.asarray(b)), np.linalg.solve(A_np, b), rtol=1e-9
    )
    np.testing.assert_allclose(
        logdet_from_chol(L), np.linalg.slogdet(A_np)[1], rtol=1e-10
    )
    # A singular matrix forces jitter escalation.
    U = rng.standard_normal((n, 2))
    S = jnp.asarray(U @ U.T)
    L2, used2 = stable_cholesky(S)
    assert float(used2) > 0.0
    assert np.all(np.isfinite(np.asarray(L2)))


def test_cg_fixed_iters_matches_while(rng):
    n = 40
    A = jnp.asarray(_spd(rng, n))
    b = jnp.asarray(rng.standard_normal((n, 3)))
    x_w = cg_solve(lambda v: A @ v, b, tol=1e-13, max_iters=200)
    x_f, info = cg_solve(lambda v: A @ v, b, fixed_iters=80, return_info=True)
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_w), rtol=1e-8, atol=1e-10)
    assert int(info.iterations) == 80
    # differentiable through custom_linear_solve as well
    theta0 = 0.3
    g = jax.grad(
        lambda t: jnp.dot(b[:, 0], cg_solve(lambda v: A @ v + t * v, b[:, 0], fixed_iters=100))
    )(theta0)
    Ainv_b = np.linalg.solve(np.asarray(A) + theta0 * np.eye(n), np.asarray(b[:, 0]))
    np.testing.assert_allclose(float(g), -(Ainv_b @ Ainv_b), rtol=1e-6)


def test_kron_deflation_preconditioner_oracle(rng):
    """M_inv matches the dense inverse of the deflated operator."""
    from gp_grief_jax.ops import kron_deflation_preconditioner, kron_eigh, kron_expand
    from gp_grief_jax.ops.topk import top_p_kron_eigs
    from gp_grief_jax.ops.khatri_rao import kr_expand

    sizes, p, sigma2 = (4, 3, 5), 7, 0.3
    fs = []
    for m in sizes:
        A = rng.standard_normal((m, m))
        fs.append(jnp.asarray(A @ A.T + m * np.eye(m)))
    Qs, lams = kron_eigh(fs)
    _, idx = top_p_kron_eigs(lams, p)
    M_inv = kron_deflation_preconditioner(Qs, lams, idx, sigma2)
    # Dense M: Q_p Λ_p Q_pᵀ + σ²I with Q_p columns = ⊗ selected eigencolumns.
    idx_np = np.asarray(idx)
    Qp = np.stack(
        [
            np.asarray(kron_expand([Qs[d][:, [idx_np[j, d]]] for d in range(3)]))[:, 0]
            for j in range(p)
        ],
        axis=1,
    )
    lam_p = np.prod([np.asarray(lams[d])[idx_np[:, d]] for d in range(3)], axis=0)
    m = int(np.prod(sizes))
    M = Qp @ np.diag(lam_p) @ Qp.T + sigma2 * np.eye(m)
    v = rng.standard_normal(m)
    got = np.asarray(M_inv(jnp.asarray(v)))
    ref = np.linalg.solve(M, v)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)


def test_lowrank_preconditioner_oracle(rng):
    from gp_grief_jax.ops import lowrank_preconditioner

    n, k, sigma2 = 30, 5, 0.2
    U = jnp.asarray(rng.standard_normal((n, k)))
    lam = jnp.asarray(rng.uniform(0.5, 2.0, k))
    M = np.asarray(U) @ np.diag(np.asarray(lam)) @ np.asarray(U).T + sigma2 * np.eye(n)
    v = rng.standard_normal((n, 3))
    got = np.asarray(lowrank_preconditioner(U, lam, sigma2)(jnp.asarray(v)))
    np.testing.assert_allclose(got, np.linalg.solve(M, v), rtol=1e-8, atol=1e-10)


def test_deflation_cuts_cg_iterations(rng):
    """RBF grid operator: deflated CG converges in far fewer iterations."""
    import gp_grief_jax as gpx
    from gp_grief_jax.ops import kron_deflation_preconditioner, kron_eigh, kron_matvec
    from gp_grief_jax.ops.cg import cg_solve
    from gp_grief_jax.ops.topk import top_p_kron_eigs
    from gp_grief_jax.kernels.grid import cov_grid

    xg = tuple(jnp.asarray(np.linspace(0, 1, 16)[:, None]) for _ in range(3))
    kerns = [gpx.make_kernel("rbf", lengthscale=0.3) for _ in range(3)]
    factors = cov_grid(kerns, xg, dim_noise_var=1e-8)
    sigma2 = 1e-2
    m = 16**3
    b = jnp.asarray(rng.standard_normal(m))
    mv = lambda v: kron_matvec(factors, v) + sigma2 * v
    _, info0 = cg_solve(mv, b, tol=1e-8, max_iters=500, return_info=True)
    Qs, lams = kron_eigh(factors)
    lams = tuple(jnp.maximum(l, 1e-12) for l in lams)
    _, idx = top_p_kron_eigs(lams, 64)
    M_inv = kron_deflation_preconditioner(Qs, lams, idx, sigma2)
    x, info1 = cg_solve(mv, b, tol=1e-8, max_iters=500, M_inv=M_inv, return_info=True)
    assert int(info1.iterations) < int(info0.iterations) / 3, (
        int(info0.iterations), int(info1.iterations))
    # and the solution is right
    r = mv(x) - b
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(b)) < 1e-6


def test_gpkron_cg_preconditioned_matches_schur():
    import gp_grief_jax as gpx
    from gp_grief_jax.models import GPKroneckerRegression

    rng = np.random.default_rng(5)
    gs = [np.linspace(0, 1, 10)[:, None]] * 3
    pts = np.stack(np.meshgrid(*[g[:, 0] for g in gs], indexing="ij"), -1).reshape(-1, 3)
    y = np.sin(3 * pts[:, 0]) + 0.05 * rng.standard_normal(len(pts))
    kerns = [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(3)]
    ref = GPKroneckerRegression(gs, y, kerns, noise_var=0.05, solver="schur")
    pc = GPKroneckerRegression(
        gs, y, kerns, noise_var=0.05, solver="cg", cg_tol=1e-10, precond_rank=32
    )
    assert abs(ref.log_likelihood() - pc.log_likelihood()) / abs(ref.log_likelihood()) < 1e-8


def test_cg_solve_refined_reaches_exact_tolerance(rng):
    """Mixed-precision refinement: a deliberately PERTURBED fast matvec (1e-3
    relative error, emulating bf16 products) still converges to the EXACT
    operator's solution at 1e-8 — accuracy is set by the residual refreshes."""
    from gp_grief_jax.ops.cg import cg_solve_refined

    n = 120
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    E = rng.standard_normal((n, n))
    E = 1e-3 * np.linalg.norm(A) / np.linalg.norm(E) * E
    E = (E + E.T) / 2
    Aj = jnp.asarray(A)
    Afast = jnp.asarray(A + E)  # "low-precision" operator
    b = jnp.asarray(rng.standard_normal((n, 2)))

    x = cg_solve_refined(
        lambda v: Afast @ v, lambda v: Aj @ v, b,
        tol=1e-10, inner_iters=30, max_restarts=30,
    )
    ref = np.linalg.solve(A, np.asarray(b))
    rel = np.abs(np.asarray(x) - ref).max() / np.abs(ref).max()
    assert rel < 1e-8, rel
    # sanity: plain CG on the PERTURBED operator alone cannot do better than ~1e-3
    from gp_grief_jax.ops.cg import cg_solve
    x_fast = cg_solve(lambda v: Afast @ v, b, tol=1e-12, max_iters=2000)
    rel_fast = np.abs(np.asarray(x_fast) - ref).max() / np.abs(ref).max()
    assert rel_fast > 1e-5  # the refinement genuinely added accuracy


def test_cg_solve_refined_info_and_single_rhs(rng):
    from gp_grief_jax.ops.cg import cg_solve_refined

    n = 60
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    Aj = jnp.asarray(A)
    b = jnp.asarray(rng.standard_normal(n))
    x, info = cg_solve_refined(
        lambda v: Aj @ v, lambda v: Aj @ v, b,
        tol=1e-9, inner_iters=25, max_restarts=10, return_info=True,
    )
    ref = np.linalg.solve(A, np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-6, atol=1e-8)
    assert int(info.iterations) % 25 == 0 and int(info.iterations) > 0
    assert float(info.residual_norm.max()) <= 1e-9 * np.linalg.norm(np.asarray(b)) * 1.01


def test_lanczos_batched_matches_single(rng):
    """Column-batched Lanczos == per-column single Lanczos (no reorth)."""
    from gp_grief_jax.ops.lanczos import lanczos, lanczos_batched

    n, R, k = 80, 5, 25
    A_np = _spd(rng, n)
    A = jnp.asarray(A_np)
    V0 = jnp.asarray(rng.standard_normal((n, R)))
    al_b, be_b, nv_b = lanczos_batched(lambda V: A @ V, V0, k)
    for j in range(R):
        res = lanczos(
            lambda v: A @ v, V0[:, j], k, full_reorth=False, store_basis=False
        )
        np.testing.assert_allclose(np.asarray(al_b[:, j]), np.asarray(res.alpha), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(be_b[:, j]), np.asarray(res.beta), rtol=1e-9, atol=1e-11)
        assert int(nv_b[j]) == int(res.num_valid)


def test_slq_logdet_batched_default_accuracy(rng):
    """slq_logdet's default (column-batched) path estimates log|A| correctly."""
    n = 120
    A_np = _spd(rng, n)
    A = jnp.asarray(A_np)
    ref = np.linalg.slogdet(A_np)[1]
    est = slq_logdet(
        lambda V: A @ V, n, key=jax.random.PRNGKey(0),
        num_probes=64, lanczos_iters=40, dtype=jnp.float64,
    )
    np.testing.assert_allclose(float(est), ref, rtol=0.05)


def test_cg_bm_layout_matches_col(rng):
    """Batch-major (B, m) CG state gives the same solutions + gradients as
    the column layout."""
    n, B = 35, 3
    A = jnp.asarray(_spd(rng, n))
    rhs = jnp.asarray(rng.standard_normal((n, B)))
    mv_col = lambda v: A @ v
    mv_bm = lambda v: v @ A  # symmetric A
    x_col = cg_solve(mv_col, rhs, tol=1e-12, max_iters=200)
    x_bm = cg_solve(mv_bm, rhs.T, tol=1e-12, max_iters=200, layout="bm")
    np.testing.assert_allclose(np.asarray(x_bm).T, np.asarray(x_col), rtol=1e-7, atol=1e-9)
    # 1-D rhs round-trips through the row layout
    x1 = cg_solve(mv_bm, rhs[:, 0], tol=1e-12, max_iters=200, layout="bm")
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x_col[:, 0]), rtol=1e-7, atol=1e-9)
    # info path + fixed iters
    x_f, info = cg_solve(
        mv_bm, rhs.T, fixed_iters=60, layout="bm", return_info=True
    )
    assert info.residual_norm.shape == (B,)
    np.testing.assert_allclose(np.asarray(x_f).T, np.asarray(x_col), rtol=1e-6, atol=1e-8)

    # gradients agree between layouts (implicit adjoint through the solve)
    def f_col(A_, b_):
        return jnp.sum(cg_solve(lambda v: A_ @ v, b_, tol=1e-12, max_iters=200) ** 2)

    def f_bm(A_, b_):
        return jnp.sum(
            cg_solve(lambda v: v @ A_, b_.T, tol=1e-12, max_iters=200, layout="bm") ** 2
        )

    gA1, gb1 = jax.grad(f_col, argnums=(0, 1))(A, rhs)
    gA2, gb2 = jax.grad(f_bm, argnums=(0, 1))(A, rhs)
    # v ↦ v @ A applies Aᵀ to columns, so ∂f/∂A transposes between layouts
    # (identical values here only because A is symmetric-valued).
    np.testing.assert_allclose(np.asarray(gA2), np.asarray(gA1).T, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(gb2), np.asarray(gb1), rtol=1e-6, atol=1e-8)


def test_cg_refined_bm_layout(rng):
    n, B = 40, 2
    A = jnp.asarray(_spd(rng, n, cond=100.0))
    rhs = jnp.asarray(rng.standard_normal((n, B)))
    from gp_grief_jax.ops import cg_solve_refined

    mv = lambda v: v @ A
    x = cg_solve_refined(mv, mv, rhs.T, tol=1e-10, inner_iters=25, max_restarts=20, layout="bm")
    xe = np.linalg.solve(np.asarray(A), np.asarray(rhs))
    np.testing.assert_allclose(np.asarray(x).T, xe, rtol=1e-6, atol=1e-8)


def test_slq_logdet_bm_layout(rng):
    n = 50
    A = jnp.asarray(_spd(rng, n, cond=50.0))
    key = jax.random.PRNGKey(3)
    ld_bm = slq_logdet(
        lambda v: v @ A, n, key=key, num_probes=30, lanczos_iters=40, layout="bm",
        dtype=A.dtype,
    )
    _, ld_true = np.linalg.slogdet(np.asarray(A))
    assert abs(float(ld_bm) - ld_true) / abs(ld_true) < 0.05


def test_lowrank_sqrt_ops_bm_layout(rng):
    from gp_grief_jax.ops.precond import lowrank_sqrt_ops

    n, r, B = 30, 5, 4
    U_full, _ = np.linalg.qr(rng.standard_normal((n, r)))
    U = jnp.asarray(U_full)
    lam = jnp.asarray(np.abs(rng.standard_normal(r)) + 1.0)
    sigma2 = 0.3
    M_inv_c, M_is_c, ld_c = lowrank_sqrt_ops(U, lam, sigma2)
    M_inv_b, M_is_b, ld_b = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
    V = jnp.asarray(rng.standard_normal((n, B)))
    np.testing.assert_allclose(
        np.asarray(M_inv_b(V.T)).T, np.asarray(M_inv_c(V)), rtol=1e-6, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(M_is_b(V.T)).T, np.asarray(M_is_c(V)), rtol=1e-6, atol=1e-8
    )
    assert float(ld_b) == float(ld_c)


def test_cg_breakdown_guard_indefinite(rng):
    """Non-positive curvature freezes the column instead of overflowing.

    On a (numerically) indefinite operator, classic CG's alpha = rz/pAp steps
    away from the solution once pAp goes negative and overflows to NaN within
    tens of iterations — observed at f32 on kappa ~ 1e9 SKI lattices.
    The guard must return FINITE iterates with honest
    residuals, in both the while_loop and fixed-iteration forms.
    """
    import jax.numpy as jnp

    from gp_grief_jax.ops.cg import cg_solve

    n = 64
    evals = np.linspace(1.0, 2.0, n)
    evals[-1] = -1e-3  # slightly indefinite
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (q * evals) @ q.T
    A = jnp.asarray(0.5 * (A + A.T), jnp.float32)
    b = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))

    mv = lambda v: A @ v
    x, info = cg_solve(mv, b, tol=1e-7, max_iters=500, return_info=True)
    assert bool(jnp.all(jnp.isfinite(x)))
    assert bool(jnp.all(jnp.isfinite(info.residual_norm)))

    x2, info2 = cg_solve(
        mv, b, tol=1e-7, max_iters=200, fixed_iters=200, return_info=True
    )
    assert bool(jnp.all(jnp.isfinite(x2)))
    assert bool(jnp.all(jnp.isfinite(info2.residual_norm)))


def test_cg_solve_refined_bf16_state_matches_f32(rng):
    """state_dtype=bf16 stores the inner CG state in bf16; the outer exact
    refreshes must still drive the solution to the same tolerance as the
    f32-state solver (possibly in more restarts)."""
    from gp_grief_jax.ops.cg import cg_solve_refined

    n = 120
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    Aj = jnp.asarray(A, jnp.float32)
    b = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)

    kw = dict(tol=1e-6, inner_iters=25, max_restarts=40, return_info=True)
    x32, i32 = cg_solve_refined(lambda v: Aj @ v, lambda v: Aj @ v, b, **kw)
    x16, i16 = cg_solve_refined(
        lambda v: Aj @ v, lambda v: Aj @ v, b, state_dtype=jnp.bfloat16, **kw
    )
    ref = np.linalg.solve(A.astype(np.float64), np.asarray(b, np.float64))
    for x, info in ((x32, i32), (x16, i16)):
        rel = np.abs(np.asarray(x, np.float64) - ref).max() / np.abs(ref).max()
        assert rel < 1e-4, rel
        bn = np.linalg.norm(np.asarray(b), axis=0)
        assert float(info.residual_norm.max()) <= 1e-6 * bn.max() * 1.05


def test_cg_fixed_bf16_state_layout_bm_and_precond(rng):
    """bf16 state composes with layout='bm' and a preconditioner."""
    from gp_grief_jax.ops.cg import _cg_fixed

    n, B = 96, 4
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    Aj = jnp.asarray(A, jnp.float32)
    d_inv = jnp.asarray(1.0 / np.diag(A), jnp.float32)
    rhs = jnp.asarray(rng.standard_normal((B, n)), jnp.float32)

    x, info = _cg_fixed(
        lambda v: v.astype(jnp.float32) @ Aj.T,
        rhs, None, 80,
        lambda r: r * d_inv[None, :],
        layout="bm", state_dtype=jnp.bfloat16,
    )
    ref = np.linalg.solve(A, np.asarray(rhs).T).T
    rel = np.abs(np.asarray(x) - ref).max() / np.abs(ref).max()
    # bf16 inner state stagnates around ~1e-3 relative — that's its contract
    assert rel < 5e-3, rel
    assert np.all(np.isfinite(np.asarray(info.residual_norm)))


def test_pivoted_cholesky_oracle(rng):
    """Full-rank pivoted Cholesky reconstructs K exactly; truncation error is
    bounded by the trace of the discarded Schur complement (greedy-diagonal
    contract), and exhausted diagonals yield inert zero columns."""
    from gp_grief_jax.ops import pivoted_cholesky

    n = 40
    x = np.sort(rng.uniform(0, 4, n))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.5**2)
    Kj = jnp.asarray(K)

    L_full = np.asarray(pivoted_cholesky(Kj, n))
    np.testing.assert_allclose(L_full @ L_full.T, K, rtol=0, atol=1e-8)

    # Low rank: fast-decaying RBF spectrum -> tiny residual at r=15.
    L = np.asarray(pivoted_cholesky(Kj, 15))
    assert np.abs(K - L @ L.T).max() < 1e-4

    # rank > numerical rank: the extra columns must be exactly zero, not NaN.
    K1 = np.ones((8, 8))  # rank 1
    L1 = np.asarray(pivoted_cholesky(jnp.asarray(K1), 5))
    assert np.all(np.isfinite(L1))
    np.testing.assert_allclose(L1 @ L1.T, K1, atol=1e-12)
    assert np.allclose(L1[:, 1:], 0.0)


def test_lowrank_sqrt_ops_from_factor_oracle(rng):
    """Spectral ops from a RAW factor match dense linalg: M⁻¹, M^{-1/2}
    (squares to M⁻¹), and log|M| — with and without weights, both layouts."""
    from gp_grief_jax.ops import lowrank_sqrt_ops_from_factor

    n, r, sigma2 = 36, 6, 0.17
    F = rng.standard_normal((n, r)) * np.logspace(0, -3, r)[None, :]
    w = rng.uniform(0.5, 3.0, r)
    for weights in (None, w):
        ww = np.ones(r) if weights is None else weights
        M = F @ np.diag(ww) @ F.T + sigma2 * np.eye(n)
        M_inv, M_inv_sqrt, logdet_M = lowrank_sqrt_ops_from_factor(
            jnp.asarray(F), sigma2,
            weights=None if weights is None else jnp.asarray(weights),
        )
        v = rng.standard_normal((n, 3))
        np.testing.assert_allclose(
            np.asarray(M_inv(jnp.asarray(v))), np.linalg.solve(M, v),
            rtol=1e-7, atol=1e-9,
        )
        half = M_inv_sqrt(M_inv_sqrt(jnp.asarray(v)))
        np.testing.assert_allclose(
            np.asarray(half), np.linalg.solve(M, v), rtol=1e-7, atol=1e-9,
        )
        np.testing.assert_allclose(
            float(logdet_M), np.linalg.slogdet(M)[1], rtol=1e-9,
        )
    # batch-major layout agrees with column layout
    M_inv_bm, _, _ = lowrank_sqrt_ops_from_factor(
        jnp.asarray(F), sigma2, weights=jnp.asarray(w), layout="bm"
    )
    M_inv_col, _, _ = lowrank_sqrt_ops_from_factor(
        jnp.asarray(F), sigma2, weights=jnp.asarray(w)
    )
    v = rng.standard_normal((4, n))
    np.testing.assert_allclose(
        np.asarray(M_inv_bm(jnp.asarray(v))),
        np.asarray(M_inv_col(jnp.asarray(v.T))).T,
        rtol=1e-10, atol=1e-12,
    )


def test_cg_segmented_matches_cg(rng):
    """Host-segmented CG == dense solve, both layouts, preconditioned."""
    from gp_grief_jax.ops import cg_solve_segmented

    n, B = 50, 3
    A_np = _spd(rng, n, cond=1e3)
    A = jnp.asarray(A_np)
    d = jnp.asarray(np.diag(A_np))
    rhs_np = rng.standard_normal((n, B))
    want = np.linalg.solve(A_np, rhs_np)
    for layout in ("col", "bm"):
        rhs = jnp.asarray(rhs_np if layout == "col" else rhs_np.T)
        mv = (lambda v: A @ v) if layout == "col" else (lambda v: v @ A)
        M_inv = (
            (lambda r: r / d[:, None])
            if layout == "col"
            else (lambda r: r / d[None, :])
        )
        x, info = cg_solve_segmented(
            mv, rhs, tol=1e-10, segment_iters=20, max_segments=30,
            M_inv=M_inv, layout=layout, return_info=True,
        )
        got = np.asarray(x) if layout == "col" else np.asarray(x).T
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
        # iteration count is segment-granular
        assert int(info.iterations) % 20 == 0


def test_cg_segmented_early_stop_and_single_rhs(rng):
    """The host loop stops as soon as the fetched residual converges (far
    fewer segments than the budget), and the 1-D rhs round-trips."""
    from gp_grief_jax.ops import cg_solve_segmented

    n = 40
    A_np = _spd(rng, n, cond=10.0)
    A = jnp.asarray(A_np)
    b = jnp.asarray(rng.standard_normal(n))
    x, info = cg_solve_segmented(
        lambda v: A @ v, b, tol=1e-12, segment_iters=25, max_segments=40,
        return_info=True,
    )
    assert x.shape == (n,)
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(A_np, np.asarray(b)), rtol=1e-7
    )
    assert int(info.iterations) <= 3 * 25  # nowhere near 40 segments


def test_slq_logdet_segmented_accuracy(rng):
    """Probe-chunked SLQ (uneven final chunk) ≈ dense logdet."""
    from gp_grief_jax.ops import slq_logdet_segmented

    n = 60
    A_np = _spd(rng, n, cond=50.0)
    A = jnp.asarray(A_np)
    ld = slq_logdet_segmented(
        lambda v: v @ A, n, key=jax.random.PRNGKey(0), num_probes=48,
        lanczos_iters=30, dtype=A.dtype, layout="bm", probe_chunk=10,
    )
    _, want = np.linalg.slogdet(A_np)
    assert abs(ld - want) / abs(want) < 5e-2


def test_slq_logdet_iter_segmented_matches_chunked(rng):
    """Iteration-segmented SLQ (recurrence carry threaded across host
    dispatches; round-4 — required when one matvec costs seconds) runs the
    SAME recurrence with the SAME probe draws as the probe-chunked form, so
    the two agree to recurrence arithmetic precision — including uneven
    final segments and early breakdowns."""
    from gp_grief_jax.ops import slq_logdet_segmented

    n = 60
    A_np = _spd(rng, n, cond=50.0)
    A = jnp.asarray(A_np)
    kw = dict(key=jax.random.PRNGKey(0), num_probes=12, lanczos_iters=30,
              dtype=A.dtype, layout="bm", probe_chunk=5)
    base = slq_logdet_segmented(lambda v: v @ A, n, **kw)
    for seg in (7, 30, 1):  # uneven, whole-recurrence, per-iteration
        it = slq_logdet_segmented(lambda v: v @ A, n, iter_segment=seg, **kw)
        np.testing.assert_allclose(it, base, rtol=1e-5), seg
    # breakdown path: rank-3 + sigma I breaks down in ~4 iterations
    L = rng.standard_normal((n, 3))
    B_np = L @ L.T + 0.5 * np.eye(n)
    B = jnp.asarray(B_np)
    base_b = slq_logdet_segmented(lambda v: v @ B, n, **kw)
    it_b = slq_logdet_segmented(lambda v: v @ B, n, iter_segment=4, **kw)
    np.testing.assert_allclose(it_b, base_b, rtol=1e-5)


def test_kron_deflation_sqrt_ops_oracle(rng):
    """Closed-form Kronecker-deflation spectral ops vs dense oracle:
    M_inv == inv(M), M_inv_sqrt∘M_inv_sqrt == M_inv, logdet_M exact."""
    from gp_grief_jax.ops import (
        kron_deflation_sqrt_ops,
        kron_eigh,
        kron_expand,
        top_p_kron_eigs,
    )

    fs = []
    for m_d in (5, 4):
        A = rng.standard_normal((m_d, m_d))
        fs.append(jnp.asarray(A @ A.T + m_d * np.eye(m_d)))
    Qs, lams = kron_eigh(tuple(fs))
    p, sigma2 = 7, 0.3
    log_lam, idx = top_p_kron_eigs(lams, p)
    M_inv, M_inv_sqrt, ldM = kron_deflation_sqrt_ops(Qs, lams, idx, sigma2)

    m = 20
    # Dense M from the selected eigenpairs.
    Kd = np.asarray(kron_expand(tuple(fs)))
    w_all, V_all = np.linalg.eigh(Kd)
    ordr = np.argsort(w_all)[::-1][:p]
    M = (V_all[:, ordr] * w_all[ordr]) @ V_all[:, ordr].T + sigma2 * np.eye(m)
    V = rng.standard_normal((m, 3))
    np.testing.assert_allclose(
        np.asarray(M_inv(jnp.asarray(V))), np.linalg.solve(M, V),
        rtol=1e-9, atol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(M_inv_sqrt(M_inv_sqrt(jnp.asarray(V)))),
        np.linalg.solve(M, V), rtol=1e-9, atol=1e-11,
    )
    assert abs(float(ldM) - np.linalg.slogdet(M)[1]) < 1e-8


def test_gpkron_whitened_cg_small_sigma(rng):
    """The whitened Kronecker CG path matches the exact schur NLML even at
    σ² far below ε_f32·λmax-equivalent conditioning (the regime where
    data-space PCG freezes)."""
    from gp_grief_jax.models import GPKroneckerRegression
    from gp_grief_jax import make_kernel

    gs = [np.linspace(0, 1, 9)[:, None], np.linspace(0, 2, 8)[:, None]]
    yg = rng.standard_normal(72)
    kw = dict(noise_var=1e-6, solver="cg", cg_tol=1e-12, cg_iters=500,
              precond_rank=40)
    m = GPKroneckerRegression(
        gs, yg, [make_kernel("rbf", lengthscale=0.4),
                 make_kernel("matern32", lengthscale=0.7)], **kw)
    ms = GPKroneckerRegression(
        gs, yg, [make_kernel("rbf", lengthscale=0.4),
                 make_kernel("matern32", lengthscale=0.7)],
        noise_var=1e-6, solver="schur")
    ll_cg, ll_s = m.log_likelihood(), ms.log_likelihood()
    assert abs(ll_cg - ll_s) / abs(ll_s) < 1e-7
    seg = m.log_likelihood_segmented(cg_segment_iters=40)
    assert abs(seg - ll_s) / abs(ll_s) < 1e-7


def test_cg_refined_partial_convergence_falls_back(rng):
    """When bf16 inner refinement stalls ABOVE tolerance (but below the old
    10x-reduction bar), the exact-CG fallback must finish the solve — the
    lax bar returned rel~0.05 iterates as 'solutions' (2.7x-wrong NLML at
    the 33.5M/rank-512 config)."""
    from gp_grief_jax.ops import cg_solve_refined

    n = 80
    # Ill-conditioned enough that bf16 inner CG stalls at rel ~eps_bf16*kappa
    # (far above 1e-10, but below the old 10x bar), with an iteration budget
    # the exact fallback CAN meet.
    A_np = _spd(rng, n, cond=1e4)
    A = jnp.asarray(A_np)
    b = jnp.asarray(rng.standard_normal(n))
    x, info = cg_solve_refined(
        lambda v: A @ v, lambda v: A @ v, b, tol=1e-10, inner_iters=20,
        max_restarts=10, state_dtype=jnp.bfloat16, return_info=True,
    )
    want = np.linalg.solve(A_np, np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-6, atol=1e-8)
    assert float(info.residual_norm[0]) < 1e-8 * np.linalg.norm(np.asarray(b))


def test_cg_refined_nan_inner_still_exact(rng):
    """A fast operator whose inner solve overflows to non-finite values must
    not poison the outer bookkeeping: NaN residuals map to +inf, the brake
    trips, and the exact fallback still returns the true solution (the NaN
    path previously exited looking 'converged' with x = 0)."""
    from gp_grief_jax.ops import cg_solve_refined

    n = 50
    A_np = _spd(rng, n, cond=100.0)
    A = jnp.asarray(A_np)
    b = jnp.asarray(rng.standard_normal(n))

    def mv_broken(v):  # denormal curvature → alpha = rz/pAp overflows x
        return A @ v * 1e-300

    x, info = cg_solve_refined(
        mv_broken, lambda v: A @ v, b, tol=1e-10, inner_iters=20,
        max_restarts=10, return_info=True,
    )
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(A_np, np.asarray(b)), rtol=1e-7
    )
    assert np.isfinite(float(info.residual_norm[0]))


def test_cg_refined_segmented_matches_exact(rng):
    """Host-segmented iterative refinement —
    bf16 inner applies + exact residual refreshes — must converge to the
    exact answer; a deliberately low-precision fast operator only affects
    restart count, never the solution."""
    import jax
    from gp_grief_jax.ops.cg import cg_solve_refined_segmented

    n, B = 300, 4
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = A @ A.T / n + 0.5 * np.eye(n, dtype=np.float32)
    Aj = jnp.asarray(A)
    mv = lambda vv: jnp.matmul(vv, Aj, precision=jax.lax.Precision.HIGHEST)  # noqa: E731
    mv_fast = lambda vv: jnp.matmul(  # noqa: E731
        vv.astype(jnp.bfloat16), Aj.astype(jnp.bfloat16)
    ).astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal((B, n)), jnp.float32)
    x, info = cg_solve_refined_segmented(
        mv_fast, mv, b, tol=1e-6, inner_iters=20, max_restarts=30,
        layout="bm", state_dtype=jnp.bfloat16, return_info=True,
    )
    res = np.linalg.norm(np.asarray(mv(x) - b), axis=1)
    res /= np.linalg.norm(np.asarray(b), axis=1)
    assert res.max() < 1e-5, res
    # info's residual must honestly reflect the true residual.
    rn = np.asarray(info.residual_norm) / np.linalg.norm(np.asarray(b), axis=1)
    np.testing.assert_allclose(rn, res, rtol=0.5, atol=1e-7)
    # 1-D squeeze contract.
    x1 = cg_solve_refined_segmented(
        mv_fast, mv, b[0], tol=1e-6, inner_iters=20, max_restarts=30,
        layout="bm",
    )
    r1 = np.linalg.norm(np.asarray(mv(x1[None, :])[0] - b[0]))
    assert r1 / np.linalg.norm(np.asarray(b[0])) < 1e-5


def test_cg_refined_segmented_fallback_on_useless_fast_op(rng):
    """A catastrophically wrong fast operator must trigger the exact-CG
    fallback and still produce an exact-grade solution (mixed is never
    worse than exact in RESULT — r5 §12 rule)."""
    import jax
    from gp_grief_jax.ops.cg import cg_solve_refined_segmented

    n = 200
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = A @ A.T / n + 0.5 * np.eye(n, dtype=np.float32)
    Aj = jnp.asarray(A)
    mv = lambda vv: jnp.matmul(vv, Aj, precision=jax.lax.Precision.HIGHEST)  # noqa: E731
    bad_fast = lambda vv: -3.0 * vv  # noqa: E731  not even the right sign
    b = jnp.asarray(rng.standard_normal((2, n)), jnp.float32)
    x = cg_solve_refined_segmented(
        bad_fast, mv, b, tol=1e-6, inner_iters=10, max_restarts=5,
        layout="bm",
    )
    res = np.linalg.norm(np.asarray(mv(x) - b), axis=1)
    res /= np.linalg.norm(np.asarray(b), axis=1)
    assert res.max() < 1e-5, res


def test_cg_refined_implicit_diff_false_matches(rng):
    """implicit_diff=False (round-5: required when the exact operator is a
    scan-rebuilt matrix-free matvec inside a differentiated program — see
    cg_solve_refined's docstring) must return the same solution as the
    custom_linear_solve-wrapped path."""
    from gp_grief_jax.ops import cg_solve_refined

    n = 48
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    Aj = jnp.asarray(A)
    b = jnp.asarray(rng.standard_normal((3, n)))
    mv = lambda vv: vv @ Aj  # noqa: E731
    x_wrap = cg_solve_refined(mv, mv, b, tol=1e-10, layout="bm")
    x_raw = cg_solve_refined(mv, mv, b, tol=1e-10, layout="bm",
                             implicit_diff=False)
    np.testing.assert_allclose(np.asarray(x_raw), np.asarray(x_wrap),
                               rtol=1e-8, atol=1e-10)
