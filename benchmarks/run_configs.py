"""BASELINE.json target-config runner: one JSON line of metrics per config.

Covers the five north-star configs (BASELINE.json:7-11 / SURVEY.md §6):

1. ``sine1d``  — 1D sine N=1k, 100-pt grid, p=10, parity vs exact GP (CPU f64).
2. ``grid3d``  — 3D product-grid GP N=10k: per-dim eigh + Kron-matvec CG parity.
3. ``kin40k``  — kin40k-shaped synthetic (N=40k, d=8; the real file is used
   when present in ``benchmarks/data/``): full GRIEF NLML optimization, test
   RMSE/NLL.
4. ``uci2m``   — 2M-point synthetic (d=10): GRIEF training completes, and the
   NLML is re-evaluated at the optimum via the ITERATIVE path (CG quadratic
   term + SLQ log-det on the full n=1.9M operator) — the BASELINE.json:10
   "completes via SLQ logdet + CG" requirement, with the closed-form O(p³)
   NLML as the accuracy reference (``slq_cg_nlml_gap``).
5. ``d100``    — d=100 grid (10^100 virtual points): basis build + predict.

Run: ``python benchmarks/run_configs.py [config ...]`` (default: fast subset).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(name, **kv):
    print(json.dumps({"config": name, **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in kv.items()}}))


def sine1d():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import gp_grief_jax as gpx

    rng = np.random.default_rng(0)
    n = 1000
    x = rng.uniform(0, 4, size=(n, 1))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    xs = np.linspace(0.1, 3.9, 200)[:, None]
    f = np.sin(2 * xs[:, 0])

    t0 = time.perf_counter()
    grid = gpx.InducingGrid.build(x, mbar=100)
    model = gpx.GPGriefModel(x, y, [gpx.make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=10, noise_var=0.5)
    model.optimize(max_iters=100)
    mean, var = model.predict(xs)
    t_grief = time.perf_counter() - t0

    exact = gpx.GPRegression(x, y, gpx.make_kernel("rbf", lengthscale=0.5), noise_var=0.5)
    exact.optimize(max_iters=50)
    em, ev = exact.predict(xs)

    rmse = float(np.sqrt(np.mean((mean - f) ** 2)))
    rmse_exact = float(np.sqrt(np.mean((em - f) ** 2)))

    # Exact-parity sub-check ([B:5] "1e-4 parity"): with ON-GRID training data
    # and the full basis (p = m), the GRIEF kernel equals the exact kernel on
    # the training set and the Nyström extension is exact at test points —
    # NLML and predictive means must agree with the exact GP to f64 precision.
    xg_pts = np.asarray(grid.xg[0])  # (100, 1)
    yg = np.sin(2 * xg_pts[:, 0]) + 0.1 * np.random.default_rng(1).standard_normal(100)
    kern = gpx.make_kernel("rbf", lengthscale=0.5)
    full = gpx.GPGriefModel(xg_pts, yg, [kern], grid, n_eigs=100, noise_var=0.05, dim_noise_var=1e-10)
    og_exact = gpx.GPRegression(xg_pts, yg, kern, noise_var=0.05)
    fm = full.predict(xs, compute_var=False)
    om = og_exact.predict(xs, compute_var=False)
    _emit(
        "sine1d",
        rmse=rmse,
        rmse_exact=rmse_exact,
        rmse_gap=abs(rmse - rmse_exact),
        mean_gap=float(np.abs(mean - em).mean()),
        parity_nlml_gap=float(abs(full.log_likelihood() - og_exact.log_likelihood())),
        parity_mean_gap=float(np.abs(fm - om).max()),
        train_s=t_grief,
    )


def grid3d():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import gp_grief_jax as gpx
    from gp_grief_jax.models import GPKroneckerRegression

    rng = np.random.default_rng(0)
    gs = [np.linspace(0, 1, 22)[:, None], np.linspace(0, 2, 22)[:, None], np.linspace(-1, 1, 22)[:, None]]
    m = 22**3  # 10,648 on-grid points ≈ N=10k config
    pts = np.stack(np.meshgrid(*[g[:, 0] for g in gs], indexing="ij"), -1).reshape(-1, 3)
    y = np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1]) + 0.3 * pts[:, 2] + 0.05 * rng.standard_normal(m)

    kerns = [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(3)]
    t0 = time.perf_counter()
    schur = GPKroneckerRegression(gs, y, kerns, noise_var=0.05, solver="schur")
    ll_schur = schur.log_likelihood()
    t_schur = time.perf_counter() - t0
    t0 = time.perf_counter()
    cg = GPKroneckerRegression(gs, y, kerns, noise_var=0.05, solver="cg", cg_tol=1e-10)
    ll_cg = cg.log_likelihood()
    t_cg = time.perf_counter() - t0
    _emit(
        "grid3d",
        n=m,
        ll_schur=ll_schur,
        ll_cg=ll_cg,
        ll_rel_gap=abs(ll_schur - ll_cg) / abs(ll_schur),
        schur_s=t_schur,
        cg_s=t_cg,
    )


def kin40k(accelerator: bool = True):
    """``accelerator=False`` pins the CPU backend and runs in float64."""
    import jax

    if not accelerator:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import gp_grief_jax as gpx

    dtype = np.float32 if accelerator else np.float64
    from benchmarks.data import load_kin40k, standardize, synthetic_kin40k

    real = load_kin40k(dtype=dtype)
    if real is not None:
        xtr, ytr, xte, yte, _ = standardize(*real)
        xtr, ytr, xte, yte = (np.asarray(a, dtype=dtype) for a in (xtr, ytr, xte, yte))
        fte = yte  # no noiseless target available; RMSE is vs labels
        n, d = xtr.shape[0] + xte.shape[0], xtr.shape[1]
        tag = "kin40k_real"
    else:
        xtr, ytr, xte, yte, fte = synthetic_kin40k(dtype)
        n, d = xtr.shape[0] + xte.shape[0], xtr.shape[1]
        tag = "kin40k_synth"

    p = 400
    t0 = time.perf_counter()
    grid = gpx.InducingGrid.build(xtr, mbar=16)
    kerns = [gpx.make_kernel("rbf", lengthscale=0.7) for _ in range(d)]
    # Phase 1: full GRIEF NLML optimization of kernel hypers + weights + noise
    # (opt_kernel_params: basis rebuilt inside the traced objective).
    model = gpx.GPGriefModel(
        xtr, ytr, kerns, grid, n_eigs=p, noise_var=0.1, dtype=dtype,
        opt_kernel_params=True, dim_noise_var=1e-6,
    )
    model.optimize(optimizer="adam", max_iters=150, learning_rate=0.03)
    # Phase 2: cheap reweighting polish at the learned hypers.
    model.opt_kernel_params = False
    model.refresh_basis()
    model.optimize(optimizer="adam", max_iters=200, learning_rate=0.05)
    t_train = time.perf_counter() - t0
    mean, var = model.predict(xte, include_noise=True)
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))
    nll = float(np.mean(0.5 * np.log(2 * np.pi * var) + 0.5 * (yte - mean) ** 2 / var))
    _emit(tag, n=n, d=d, p=p, rmse=rmse, nll=nll, train_s=t_train,
          virtual_pts_log10=grid.log10_num_virtual)


def uci2m(accelerator: bool = True):
    """``accelerator=False`` pins the CPU backend (data stays float32)."""
    import jax

    if not accelerator:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import gp_grief_jax as gpx

    dtype = np.float32
    from benchmarks.data import load_uci2m, synthetic_uci2m

    real = load_uci2m(dtype=dtype)
    if real is not None:
        x, y = real
        xm, xs = x.mean(0), x.std(0) + 1e-12
        ym, ys = y.mean(), y.std() + 1e-12
        x, y = ((x - xm) / xs).astype(dtype), ((y - ym) / ys).astype(dtype)
        n, d = x.shape
        f = y  # RMSE vs labels on the real task
        tag = "uci2m_real"
    else:
        x, y, f = synthetic_uci2m(dtype)
        n, d = x.shape
        tag = "uci2m_synth"
    # Proportional splits so a smaller-than-2M real file still runs end to
    # end (the loaders accept any n; a hardcoded 100k test split would make
    # the train split empty below 100k rows).
    n_te = min(100_000, max(1, n // 5))
    xte, yte, fte = x[-n_te:], y[-n_te:], f[-n_te:]
    xtr, ytr = x[:-n_te], y[:-n_te]

    t0 = time.perf_counter()
    grid = gpx.InducingGrid.build(xtr[:200000], mbar=10)  # grid from a subsample
    model = gpx.GPGriefModel(
        xtr, ytr, gpx.make_kernel("rbf", lengthscale=1.0, input_dim=1), grid,
        n_eigs=400, noise_var=0.2, dtype=dtype,
    )
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05)
    t_train = time.perf_counter() - t0
    mean = model.predict(xte, compute_var=False)
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))
    # BASELINE.json:10: the 2M config must complete via SLQ logdet + CG.
    # Run the iterative NLML on the FULL n=1.9M operator at the optimum and
    # compare against the closed-form O(p³) NLML.  Rank-100 deflation
    # preconditions BOTH the CG and the SLQ (whitened operator — see
    # models/gp_grief.py:log_likelihood_iterative); unpreconditioned SLQ at
    # this σ²≈0.02 needs hundreds of Lanczos nodes for ~0.5% logdet accuracy.
    ll_closed = model.log_likelihood()
    t0 = time.perf_counter()
    # Segmented evaluator (models/gp_grief.py:log_likelihood_iterative_
    # segmented): a host loop of bounded device programs — 50-iteration CG
    # segments and 4-probe SLQ chunks — with the solver state on the device
    # between them.
    ll_iter = model.log_likelihood_iterative_segmented(
        num_probes=8, lanczos_iters=48, cg_tol=1e-5, cg_iters=300,
        precond_rank=300, cg_segment_iters=50, probe_chunk=4,
    )
    t_iter = time.perf_counter() - t0
    _emit(
        tag,
        n=n,
        d=d,
        p=400,
        rmse=rmse,
        basis_s=t_build,
        train_s=t_train,
        nlml_closed=ll_closed,
        nlml_slq_cg=ll_iter,
        slq_cg_nlml_gap=abs(ll_iter - ll_closed) / abs(ll_closed),
        slq_cg_s=t_iter,
    )


def d100():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import gp_grief_jax as gpx

    rng = np.random.default_rng(0)
    n, d, p = 1000, 100, 300
    x = rng.uniform(0, 1, size=(n, d))
    y = np.sin(4 * x[:, 0]) + 0.7 * np.cos(3 * x[:, 1]) + 0.05 * rng.standard_normal(n)
    t0 = time.perf_counter()
    grid = gpx.InducingGrid.build(x, mbar=10)
    model = gpx.GPGriefModel(x, y, gpx.make_kernel("rbf", lengthscale=1.5), grid, n_eigs=p, noise_var=0.1)
    ll = model.log_likelihood()
    t_build = time.perf_counter() - t0
    model.optimize(optimizer="adam", max_iters=50, learning_rate=0.05)
    mean, var = model.predict(x[:100])
    _emit(
        "d100",
        virtual_pts_log10=grid.log10_num_virtual,
        ll=ll,
        ll_opt=model.log_likelihood(),
        build_s=t_build,
        pred_finite=bool(np.all(np.isfinite(mean)) and np.all(np.isfinite(var))),
    )


ALL = {"sine1d": sine1d, "grid3d": grid3d, "kin40k": kin40k, "uci2m": uci2m, "d100": d100}

if __name__ == "__main__":
    from gp_grief_jax.utils import enable_compilation_cache

    enable_compilation_cache()
    names = sys.argv[1:] or ["sine1d", "grid3d", "d100"]
    for name in names:
        ALL[name]()
