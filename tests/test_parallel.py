"""Multi-device tests on the 8 virtual CPU devices (SURVEY.md §4 item 4):
sharded stats/NLML must match single-device results exactly, gradients must
flow through shard_map, and sharded CG/SLQ must psum correctly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from gp_grief_jax import GPGriefModel, InducingGrid, make_kernel
from gp_grief_jax.kernels import build_basis, phi
from gp_grief_jax.models.base import basis_nlml, BasisStats
from gp_grief_jax.ops import cg_solve, slq_logdet
from gp_grief_jax.parallel import (
    data_mesh,
    make_mesh,
    pad_to_multiple,
    sharded_basis_stats,
    sharded_grief_nlml,
    stacked_eigh_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    return data_mesh()


def _data(rng, n=101, d=2):
    x = rng.uniform(0, 1, size=(n, d))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y


def test_sharded_stats_match_local(rng, mesh):
    x, y = _data(rng)
    grid = InducingGrid.build(x, mbar=7)
    kerns = [make_kernel("rbf", lengthscale=0.5) for _ in range(2)]
    xg = tuple(jnp.asarray(g) for g in grid.xg)
    p = 12
    basis = build_basis(kerns, xg, p)

    xp, mask = pad_to_multiple(x, len(mesh.devices))
    yp, _ = pad_to_multiple(y, len(mesh.devices))
    stats = sharded_basis_stats(
        basis, kerns, xg, jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask),
        mesh, n_real=len(y),
    )
    Phi = phi(basis, kerns, xg, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(stats.C), np.asarray(Phi.T @ Phi), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(stats.v), np.asarray(Phi.T @ jnp.asarray(y)), rtol=1e-10)
    np.testing.assert_allclose(float(stats.yy), float(y @ y), rtol=1e-12)


def test_sharded_nlml_matches_model_and_grads_flow(rng, mesh):
    x, y = _data(rng, n=96)
    grid = InducingGrid.build(x, mbar=6)
    kerns = [make_kernel("rbf", lengthscale=0.5) for _ in range(2)]
    xg = tuple(jnp.asarray(g) for g in grid.xg)
    p = 10
    # opt_kernel_params=True so the local objective also differentiates
    # through the basis build (matching sharded_grief_nlml semantics).
    model = GPGriefModel(
        x, y, kerns, grid, n_eigs=p, noise_var=0.2, dim_noise_var=1e-12,
        opt_kernel_params=True,
    )

    params = dict(model.params)
    xp, mask = pad_to_multiple(x, len(mesh.devices))
    yp, _ = pad_to_multiple(y, len(mesh.devices))

    def loss(params):
        return sharded_grief_nlml(
            params, xg, jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask),
            mesh, n_eigs=p, n_real=len(y),
        )

    nlml_sharded = float(jax.jit(loss)(params))
    np.testing.assert_allclose(nlml_sharded, -model.log_likelihood(), rtol=1e-10)

    g = jax.jit(jax.grad(loss))(params)
    g_local = jax.jit(jax.grad(model._loss))(model.params)
    np.testing.assert_allclose(
        np.asarray(g["log_w"]), np.asarray(g_local["log_w"]), rtol=1e-8, atol=1e-12
    )
    np.testing.assert_allclose(
        float(g["log_noise"]), float(g_local["log_noise"]), rtol=1e-8
    )
    # Kernel-hyper grads (through the replicated basis build) must also agree.
    np.testing.assert_allclose(
        float(g["kernels"][0].log_lengthscale),
        float(g_local["kernels"][0].log_lengthscale),
        rtol=1e-6,
    )


def test_sharded_cg(rng, mesh):
    n = 64
    A_np = rng.standard_normal((n, n))
    A_np = A_np @ A_np.T + n * np.eye(n)
    b_np = rng.standard_normal(n)
    A, b = jnp.asarray(A_np), jnp.asarray(b_np)

    def solve(A, b):
        # A row-sharded; matvec all-gathers v (n is small here; real use
        # computes local Gram blocks on the fly).
        def mv(v_local):
            v_full = jax.lax.all_gather(v_local, "data", axis=0, tiled=True)
            return A @ v_full

        return cg_solve(mv, b, tol=1e-12, max_iters=300, axis_name="data")

    x = shard_map(
        solve, mesh=mesh,
        in_specs=(P("data", None), P("data")), out_specs=P("data"),
        check_vma=False,
    )(A, b)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A_np, b_np), rtol=1e-7)


def test_sharded_slq_logdet(rng, mesh):
    n = 128
    A_np = rng.standard_normal((n, n))
    A_np = A_np @ A_np.T + n * np.eye(n)
    A = jnp.asarray(A_np)

    def ld(A):
        def mv(v_local):
            v_full = jax.lax.all_gather(v_local, "data", axis=0, tiled=True)
            return A @ v_full

        return slq_logdet(
            mv, n // 8, key=jax.random.PRNGKey(0), num_probes=48,
            lanczos_iters=30, dtype=jnp.float64, axis_name="data",
        )

    est = shard_map(
        ld, mesh=mesh, in_specs=(P("data", None),), out_specs=P(), check_vma=False
    )(A)
    ref = np.linalg.slogdet(A_np)[1]
    np.testing.assert_allclose(float(est), ref, rtol=0.05)


def test_stacked_eigh_sharded(rng):
    mesh2 = make_mesh((4, 2), ("data", "model"))
    d, m = 6, 8
    Ks_np = np.stack([rng.standard_normal((m, m)) for _ in range(d)])
    Ks_np = Ks_np @ np.transpose(Ks_np, (0, 2, 1)) + m * np.eye(m)
    Ks = jnp.asarray(Ks_np)

    Qs, lams = jax.jit(lambda K: stacked_eigh_sharded(K, mesh2))(Ks)
    for i in range(d):
        recon = np.asarray(Qs[i]) * np.asarray(lams[i]) @ np.asarray(Qs[i]).T
        np.testing.assert_allclose(recon, Ks_np[i], rtol=1e-8, atol=1e-8)


def test_sharded_model_matches_single_device(rng, mesh):
    from gp_grief_jax.parallel import ShardedGPGriefModel

    x, y = _data(rng, n=90)
    grid = InducingGrid.build(x, mbar=6)
    kerns = [make_kernel("rbf", lengthscale=0.5) for _ in range(2)]
    local = GPGriefModel(
        x, y, kerns, grid, n_eigs=10, noise_var=0.2, dim_noise_var=1e-12,
        opt_kernel_params=True,
    )
    sharded = ShardedGPGriefModel(
        x, y, kerns, grid, n_eigs=10, noise_var=0.2, dim_noise_var=1e-12, mesh=mesh,
    )
    np.testing.assert_allclose(sharded.log_likelihood(), local.log_likelihood(), rtol=1e-10)

    res = sharded.optimize(optimizer="adam", max_iters=15, learning_rate=0.05)
    assert np.all(np.isfinite(res.losses))
    assert sharded.log_likelihood() > -np.inf
    xs = rng.uniform(0, 1, size=(7, 2))
    sm, sv = sharded.predict(xs)
    assert np.all(np.isfinite(sm)) and np.all(sv >= 0)
    # After identical short training, predictions track the local model.
    local.optimize(optimizer="adam", max_iters=15, learning_rate=0.05)
    lm = local.predict(xs, compute_var=False)
    np.testing.assert_allclose(sm, lm, atol=5e-3)


@pytest.mark.slow
def test_sharded_model_grouped_dims_matches_single_device(rng, mesh):
    """Grouped grid dimensions (the reference's sub_dim capability) through
    the sharded reductions: NLML and predictions == GPGriefModel exactly."""
    from gp_grief_jax.parallel import ShardedGPGriefModel

    x, y = _data(rng, n=88, d=3)
    grid = InducingGrid.build(x, mbar=[6, 12], dims=[[0], [1, 2]])
    kerns = [make_kernel("rbf", lengthscale=0.6) for _ in range(2)]
    local = GPGriefModel(
        x, y, kerns, grid, n_eigs=10, noise_var=0.3, opt_kernel_params=True
    )
    sharded = ShardedGPGriefModel(
        x, y, kerns, grid, n_eigs=10, noise_var=0.3, mesh=mesh
    )
    assert sharded.dims is not None  # the grouped mapping actually engaged
    np.testing.assert_allclose(
        sharded.log_likelihood(), local.log_likelihood(), rtol=1e-10
    )
    xs = rng.uniform(0, 1, size=(9, 3))
    sm, sv = sharded.predict(xs)
    lm, lv = local.predict(xs)
    np.testing.assert_allclose(sm, lm, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sv, lv, rtol=1e-6, atol=1e-10)
    # Gradients flow through the grouped cross-covs + collectives.
    g = jax.grad(sharded._loss)(sharded.params)
    flat = jax.tree_util.tree_leaves(g)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in flat)
    assert any(np.any(np.asarray(l) != 0) for l in flat)


def test_kron_matvec_sharded_matches_single_device(rng):
    """Model-parallel lattice-sharded matvec == local to 1e-10 (2-D mesh)."""
    from gp_grief_jax.ops import kron_expand
    from gp_grief_jax.parallel import kron_matvec_sharded, make_mesh

    mesh2d = make_mesh((4, 2), ("data", "model"))
    sizes = (8, 6, 4)  # leading 8 divides the model axis (2)
    fs = tuple(jnp.asarray(rng.standard_normal((m, m))) for m in sizes)
    m = int(np.prod(sizes))
    for B in (None, 3):
        v = jnp.asarray(rng.standard_normal((m,) if B is None else (m, B)))
        got = kron_matvec_sharded(fs, v, mesh2d, axis_name="model")
        ref = np.asarray(kron_expand(fs)) @ np.asarray(v)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-10, atol=1e-10)
    # also across the 8-wide data axis of a 1-D mesh
    mesh1d = make_mesh((8,), ("model",))
    v = jnp.asarray(rng.standard_normal(m))
    got = kron_matvec_sharded(fs, v, mesh1d, axis_name="model")
    ref = np.asarray(kron_expand(fs)) @ np.asarray(v)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-10, atol=1e-10)


def test_full_sharded_train_step_2d_mesh(rng):
    """The FULL train step (sharded eigh + sharded stats + grad + Adam) on the
    (4,2) (data, model) mesh matches the single-device program."""
    import optax

    from gp_grief_jax.kernels.grid import cov_grid
    from gp_grief_jax.kernels.grief import GriefBasis, build_basis, phi as _phi
    from gp_grief_jax.models.base import basis_nlml, BasisStats
    from gp_grief_jax.ops.topk import top_p_kron_eigs
    from gp_grief_jax.parallel import (
        make_mesh,
        pad_to_multiple,
        sharded_basis_stats,
        stacked_eigh_sharded,
    )
    from gp_grief_jax import InducingGrid, make_kernel

    mesh = make_mesh((4, 2), ("data", "model"))
    n, d, p = 64, 4, 16
    x = rng.uniform(0, 1, (n, d))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    grid = InducingGrid.build(x, mbar=8)
    xg = tuple(jnp.asarray(g) for g in grid.xg)
    params = {
        "kernels": [make_kernel("rbf", lengthscale=0.4) for _ in range(d)],
        "log_w": jnp.zeros((p,)),
        "log_noise": jnp.asarray(-1.0),
    }
    xp, mask = pad_to_multiple(x, 8)
    yp, _ = pad_to_multiple(y, 8)
    xp, yp, mask = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask)

    def loss_sharded(params):
        Ks = cov_grid(params["kernels"], xg, dim_noise_var=1e-10)
        Qs_st, lams_st = stacked_eigh_sharded(jnp.stack(Ks), mesh, "model")
        Qs = tuple(Qs_st[i] for i in range(d))
        lams = tuple(lams_st[i] for i in range(d))
        log_lam, idx = top_p_kron_eigs(lams, p)
        basis = GriefBasis(Qs=Qs, lams=lams, log_lam=log_lam, idx=idx)
        stats = sharded_basis_stats(
            basis, params["kernels"], xg, xp, yp, mask, mesh, n_real=n
        )
        return basis_nlml(stats, params["log_w"], params["log_noise"])

    def loss_local(params):
        basis = build_basis(params["kernels"], xg, p, dim_noise_var=1e-10)
        Phi = _phi(basis, params["kernels"], xg, jnp.asarray(x))
        stats = BasisStats(
            C=Phi.T @ Phi, v=Phi.T @ jnp.asarray(y),
            yy=jnp.dot(jnp.asarray(y), jnp.asarray(y)), n=n,
        )
        return basis_nlml(stats, params["log_w"], params["log_noise"])

    # jit the whole value+grad programs: op-by-op eager dispatch of the
    # shard_map pipeline dominates wall time otherwise (116s -> ~35s).
    v_sh, g_sh = jax.jit(jax.value_and_grad(loss_sharded))(params)
    v_lo, g_lo = jax.jit(jax.value_and_grad(loss_local))(params)
    np.testing.assert_allclose(float(v_sh), float(v_lo), rtol=1e-10)
    for a, b in zip(jax.tree.leaves(g_sh), jax.tree.leaves(g_lo)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-10)

    # One full jitted Adam step on the 2-D mesh runs and is finite.
    opt = optax.adam(1e-2)

    @jax.jit
    def step(params, opt_state):
        value, grads = jax.value_and_grad(loss_sharded)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    p2, _, val = step(params, opt.init(params))
    assert np.isfinite(float(val))


@pytest.mark.slow
def test_sharded_ski_matches_single_device_and_dense(rng, mesh):
    """ShardedGPSKIRegression == GPSKIRegression == dense oracle.

    With FULL-rank deflation (r = M) the whitened SLQ term is exactly zero
    (the whitened operator is the identity), so the NLML is deterministic and
    the three values must agree to solver precision, not probe noise."""
    from gp_grief_jax.kernels.grid import cov_grid
    from gp_grief_jax.models.gp_ski import GPSKIRegression
    from gp_grief_jax.ops import kron_expand
    from gp_grief_jax.ops.interp import interp_expand
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 150  # not divisible by 8: exercises the pad-row congruence
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    kw = dict(
        noise_var=0.2, num_probes=32, lanczos_iters=64, cg_iters=400,
        cg_tol=1e-10, precond_rank=64,
    )
    single = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg, **kw)
    sh = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg, mesh=mesh, **kw
    )
    lls, llm = sh.log_likelihood(), single.log_likelihood()
    assert abs(lls - llm) < 1e-9

    factors = cov_grid(single.params["kernels"], single.xg, dim_noise_var=0.0)
    W = np.asarray(interp_expand(single.iw))
    K = np.asarray(kron_expand(factors))
    A = W @ K @ W.T + 0.2 * np.eye(n)
    sign, ld = np.linalg.slogdet(A)
    assert sign > 0
    nlml_dense = 0.5 * (
        float(np.asarray(y) @ np.linalg.solve(A, np.asarray(y)))
        + ld + n * np.log(2 * np.pi)
    )
    assert abs(lls + nlml_dense) / abs(nlml_dense) < 1e-8

    # Gradients flow through the collectives.
    g = jax.grad(sh._loss)(sh.params)
    from jax.flatten_util import ravel_pytree

    gv = np.asarray(ravel_pytree(g)[0])
    assert np.all(np.isfinite(gv)) and np.linalg.norm(gv) > 0

    # Prediction (mean + exact variance) matches the single-device model.
    xs = rng.uniform(0.1, 1.9, size=(37, 2))
    ms, vs = single.predict(xs)
    mh, vh = sh.predict(xs)
    np.testing.assert_allclose(mh, ms, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(vh, vs, rtol=1e-6, atol=1e-10)


def test_sharded_ski_optimize_improves(rng, mesh):
    """Data-parallel training: a few Adam steps increase the sharded NLML."""
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 160
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 6)[:, None]] * 2
    sh = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=1.5), xg, mesh=mesh,
        noise_var=0.5, num_probes=16, lanczos_iters=30, cg_iters=200,
        cg_tol=1e-8, precond_rank=36,
    )
    ll0 = sh.log_likelihood()
    res = sh.optimize(optimizer="adam", max_iters=15, learning_rate=0.1)
    assert sh.log_likelihood() > ll0
    assert np.all(np.isfinite(res.losses))


@pytest.mark.slow
def test_sharded_ski_lattice_matches_single_device(rng, mesh):
    """solver='lattice' on the mesh: replicated whitened lattice state with a
    psum-coupled ŴᵀŴ — identical probe draws make the sharded NLML equal the
    single-device dual exactly; predict matches through the dual solve."""
    from gp_grief_jax.models.gp_ski import GPSKIRegression
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 300
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    kw = dict(noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=400,
              cg_tol=1e-12, solver="lattice")
    single = GPSKIRegression(x, y, make_kernel("rbf", lengthscale=0.6), xg, **kw)
    sh = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg, mesh=mesh, **kw
    )
    lls, llm = sh.log_likelihood(), single.log_likelihood()
    assert abs(lls - llm) < 1e-10
    g = jax.grad(sh._loss)(sh.params)
    from jax.flatten_util import ravel_pytree

    gv = np.asarray(ravel_pytree(g)[0])
    assert np.all(np.isfinite(gv)) and np.linalg.norm(gv) > 0
    xs = rng.uniform(0.1, 1.9, size=(23, 2))
    ms, vs = single.predict(xs)
    mh, vh = sh.predict(xs)
    np.testing.assert_allclose(mh, ms, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(vh, vs, rtol=1e-6, atol=1e-9)
    # The replicated-stencil ŴᵀŴ (default) vs the psum'd point-space form:
    # same operator, so the dual NLML agrees to solve tolerance.
    assert sh._wtw_stencil is not None
    sh_pt = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg, mesh=mesh,
        wtw_stencil=False, **kw
    )
    assert sh_pt._wtw_stencil is None
    assert abs(sh_pt.log_likelihood() - lls) / abs(lls) < 1e-6


def test_sharded_ski_segmented_nlml_matches_monolithic(rng, mesh):
    """Round-3 missing #4: sharded log_likelihood_segmented == the monolithic
    sharded NLML.  Full-rank deflation makes the whitened SLQ exactly zero,
    so the value is probe-independent and the match is to solver precision."""
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 150
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    kw = dict(noise_var=0.2, num_probes=16, lanczos_iters=40, cg_iters=400,
              cg_tol=1e-10, precond_rank=64)
    sh = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg, mesh=mesh, **kw
    )
    mono = sh.log_likelihood()
    seg = sh.log_likelihood_segmented(cg_segment_iters=30, probe_chunk=8)
    np.testing.assert_allclose(seg, mono, rtol=1e-6)


def test_sharded_ski_segmented_nlml_lattice(rng, mesh):
    """Lattice-dual segmented NLML: identical CG recurrence, chunked SLQ —
    agreement with the monolithic sharded dual within SLQ sampling error."""
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 300
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    sh = ShardedGPSKIRegression(
        x, y, make_kernel("rbf", lengthscale=0.6), xg, mesh=mesh,
        noise_var=0.2, num_probes=32, lanczos_iters=30, cg_iters=400,
        cg_tol=1e-12, solver="lattice",
    )
    mono = sh.log_likelihood()
    seg = sh.log_likelihood_segmented(cg_segment_iters=40, probe_chunk=8)
    assert abs(seg - mono) / abs(mono) < 3e-2, (seg, mono)


def test_sharded_ski_optimize_segmented_improves(rng, mesh):
    """Sharded segmented training: segmented Adam steps must raise the
    (monolithic) sharded NLML, for both solvers."""
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 160
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 6)[:, None]] * 2
    for solver, kw in (
        ("data", dict(precond_rank=36)),
        ("lattice", dict()),
    ):
        sh = ShardedGPSKIRegression(
            x, y, make_kernel("rbf", lengthscale=1.5), xg, mesh=mesh,
            noise_var=0.5, num_probes=8, lanczos_iters=20, cg_iters=200,
            cg_tol=1e-8, solver=solver, **kw,
        )
        ll0 = sh.log_likelihood()
        res = sh.optimize_segmented(
            max_iters=12, learning_rate=0.1, num_probes=4, cg_segment_iters=30
        )
        assert np.all(np.isfinite(res.losses)), solver
        assert sh.log_likelihood() > ll0, (solver, ll0, sh.log_likelihood())


def test_gp_kron_model_parallel_log_likelihood(rng):
    """Model-level consumer of kron_matvec_sharded:
    GPKroneckerRegression(mesh=...) routes every CG matvec through the
    lattice-sharded op and must match the local model's NLML through an
    actual .log_likelihood() call (and its gradient path in optimize)."""
    from gp_grief_jax.models.gp_kron import GPKroneckerRegression
    from gp_grief_jax.parallel import make_mesh

    mesh2d = make_mesh((4, 2), ("data", "model"))
    xg = [np.linspace(0, 1, m)[:, None] for m in (8, 6, 4)]  # 8 % 2 == 0
    m = 8 * 6 * 4
    y = rng.standard_normal(m)
    kerns = [make_kernel("rbf", lengthscale=0.4) for _ in range(3)]
    kw = dict(noise_var=0.1, solver="cg", cg_tol=1e-12, cg_iters=400)
    local = GPKroneckerRegression(xg, y, kerns, **kw)
    par = GPKroneckerRegression(xg, y, kerns, mesh=mesh2d, **kw)
    np.testing.assert_allclose(
        par.log_likelihood(), local.log_likelihood(), rtol=1e-8
    )
    # preconditioned + whitened path also runs sharded
    kwp = dict(kw, precond_rank=16, cg_whiten=True)
    local_p = GPKroneckerRegression(xg, y, kerns, **kwp)
    par_p = GPKroneckerRegression(xg, y, kerns, mesh=mesh2d, **kwp)
    np.testing.assert_allclose(
        par_p.log_likelihood(), local_p.log_likelihood(), rtol=1e-8
    )
    # gradients flow through the collective (one optimize step)
    res = par.optimize(max_iters=2, optimizer="adam", learning_rate=0.05)
    assert np.isfinite(res.losses).all()
    # constructor guards: indivisible leading dim / missing axis / schur
    xg_bad = [np.linspace(0, 1, 7)[:, None]] + xg[1:]
    with pytest.raises(ValueError, match="divisible"):
        GPKroneckerRegression(xg_bad, rng.standard_normal(7 * 6 * 4), kerns,
                              mesh=mesh2d, **kw)
    with pytest.raises(ValueError, match="no axis"):
        GPKroneckerRegression(xg, y, kerns, mesh=mesh2d, model_axis="nope", **kw)
    with pytest.raises(ValueError, match="solver='cg'"):
        GPKroneckerRegression(xg, y, kerns, mesh=mesh2d, solver="schur")


def test_sharded_ski_nlml_smoke(rng, mesh):
    """Quick-tier parity smoke for the sharded SKI models (the exhaustive
    matches_single_device tests are compile-heavy and slow-marked): NLML of
    both solvers agrees with the single-chip model at a small budget."""
    from gp_grief_jax.models.gp_ski import GPSKIRegression
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    n = 96
    x = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 6)[:, None]] * 2
    kern = make_kernel("rbf", lengthscale=0.6)
    # Full-rank deflation (r = M = 36): the whitened SLQ term is exactly
    # zero, so parity is deterministic (the exhaustive tests' trick).
    kw = dict(noise_var=0.3, num_probes=4, lanczos_iters=10, cg_iters=60,
              cg_tol=1e-10, precond_rank=36)
    # Lattice dual only: the data solver's sharded path is quick-covered by
    # test_sharded_ski_optimize_improves; compiling all four models here
    # would cost ~22 s (this smoke exists to keep the quick tier quick).
    local = GPSKIRegression(x, y, kern, xg, solver="lattice", **kw)
    sh = ShardedGPSKIRegression(x, y, kern, xg, mesh=mesh, solver="lattice", **kw)
    np.testing.assert_allclose(
        sh.log_likelihood(), local.log_likelihood(), rtol=1e-6,
    )


def test_init_distributed_single_process_noop():
    """SURVEY §5 DCN row: init_distributed is a safe no-op in a single
    process (returns 1 and leaves the backend usable)."""
    from gp_grief_jax.parallel import init_distributed

    assert init_distributed() == 1
    assert len(jax.devices()) >= 1  # backend still alive
