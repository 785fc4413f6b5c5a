"""End-to-end proof that the library runs on one NVIDIA GPU.

    python chip_smoke.py               # phases D, A, B, C on one card
    python chip_smoke.py --multichip   # the sharded models on 4 cards, only

One process holds the card.  Phase D's child (pytest on the ``gpu``-marked
tests) runs and exits before this process imports JAX.  Then:

A. the main path — ``GPGriefModel`` training at the kin40k shape (n=40k,
   30k/10k split, d=8, mbar=16, p=400, ``opt_kernel_params``): 25 Adam
   steps, ``refresh_basis()``, 25 reweight steps, predict on the 10k test
   rows; NLMLs and RMSE against the same model in float64 on the CPU;
B. translation checks at real widths, each against a float64 CPU
   reference: the Kron XLA chain (d=5, m_d=32; and 16⁶, 8⁸ for the
   grouping rule) at DEFAULT and HIGHEST for each grouping width, beside a
   copy of the same bytes; the batched Φ
   build and its VJP; the ``WᵀW`` stencil apply; ``Wᵀ`` at n ≪ m; the
   device-built stencil tables;
C. coverage — one NLML and one training step for each other model class,
   each against a second route the library already has.

``--multichip`` runs only the sharded GRIEF, SKI and Kron models on a 1-D
``data`` mesh of four cards, each against the single-card model.

Every number is printed with the card's name and power limit beside it, and
every check with its value, tolerance and reason.  Any failed phase or check
exits 1 and prints no ok line, as does a run that finds no GPU (or fewer
than four with ``--multichip``).  On success the last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


class Report:
    """Prints numbers with the card beside them and collects failed checks."""

    def __init__(self, card: str):
        self.card = card
        self.failures: list[str] = []

    def num(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}  [{self.card}]", flush=True)

    def check(self, phase: str, name: str, value: float, tol: float, why: str) -> bool:
        ok = bool(np.isfinite(value)) and value <= tol
        print(
            f"[{phase}] check {name}: {value:.3e} <= {tol:.1e} "
            f"{'ok' if ok else 'FAIL'} ({why})",
            flush=True,
        )
        if not ok:
            self.failures.append(f"{phase}:{name}")
        return ok

    def require(self, phase: str, name: str, ok: bool, detail: str) -> bool:
        print(f"[{phase}] check {name}: {'ok' if ok else 'FAIL'} ({detail})", flush=True)
        if not ok:
            self.failures.append(f"{phase}:{name}")
        return ok


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _on_cpu_f64():
    """Context: run on the CPU device with float64 enabled."""
    import contextlib

    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(_cpu()))
    return stack


def _to(tree, dtype):
    import jax
    import jax.numpy as jnp

    def cast(a):
        a = np.asarray(a)
        return jnp.asarray(a, dtype) if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a)

    return jax.tree.map(cast, tree)


# ---------------------------------------------------------------------------
# Phase A — the main path
# ---------------------------------------------------------------------------


def phase_a(rep: Report, ctx: dict, *, n=40_000, n_train=30_000, mbar=16, p=400,
            steps=25) -> None:
    import jax

    import gp_grief_jax as gpx
    from benchmarks.data import synthetic_kin40k
    from gp_grief_jax.models import base as mbase
    from gp_grief_jax.utils.profiling import time_call

    xtr, ytr, xte, yte, fte = synthetic_kin40k(np.float32, n=n, n_train=n_train)
    d = xtr.shape[1]
    grid = gpx.InducingGrid.build(xtr, mbar=mbar)

    def make(dtype, params=None):
        kerns = [gpx.make_kernel("rbf", lengthscale=0.7) for _ in range(d)]
        m = gpx.GPGriefModel(
            xtr.astype(dtype), ytr.astype(dtype), kerns, grid, n_eigs=p,
            noise_var=0.1, dtype=dtype, opt_kernel_params=True, dim_noise_var=1e-6,
        )
        if params is not None:
            m.params = _to(params, dtype)
        return m

    t0 = time.perf_counter()
    model = make(np.float32)
    ll0 = model.log_likelihood()
    rep.num("A", f"build + first NLML (compile included): {time.perf_counter() - t0:.3f} s")
    with _on_cpu_f64():
        ll0_ref = make(np.float64).log_likelihood()
    # The NLML is a sum of n O(1) terms and cancels to a small total near the
    # initial params, so its f32 error is stated per data point.  At HIGHEST
    # it reads ~1e-6 per row at the initial params and ~6e-6–8e-6 after
    # training (the f32 p×p Cholesky at the trained noise level); a TF32 Gram
    # reads 7.4e-5 per row at the initial params (H100, 400 W and 700 W).
    tol_nlml = 3e-5
    why_nlml = (
        "|ΔNLML|/n: f32 Φ and Gram at HIGHEST and an f32 p×p Cholesky, whose "
        "error grows with κ as the noise falls; TF32 Gram products read 7.4e-5"
    )
    rep.check("A", "nlml_init_vs_cpu_f64_per_row", abs(ll0 - ll0_ref) / n_train,
              tol_nlml, why_nlml)

    # One training step (value_and_grad through eigh, selection, Φ, Gram)
    # at each Gram precision: NLML error against f64 and warm step time.
    chosen = mbase.GRAM_PRECISION
    step = {}
    try:
        for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST):
            mbase.GRAM_PRECISION = prec
            c, w, (val, _) = time_call(jax.value_and_grad(model._loss), model.params)
            step[prec] = w
            rep.num(
                "A",
                f"gram {prec.name}: step compile {c:.3f} s, warm {w * 1e3:.4f} ms, "
                f"NLML rel err vs f64 {abs(-float(val) - ll0_ref) / abs(ll0_ref):.3e} "
                f"(per row {abs(-float(val) - ll0_ref) / n_train:.3e})",
            )
    finally:
        mbase.GRAM_PRECISION = chosen
    ctx["a_step_s"] = step[chosen]

    t0 = time.perf_counter()
    res = model.optimize(optimizer="adam", max_iters=steps, learning_rate=0.03)
    rep.num("A", f"optimize({steps} Adam steps, opt_kernel_params) wall {time.perf_counter() - t0:.3f} s (compile included)")
    losses = np.asarray(res.losses)
    rep.require("A", "train_loss_finite_and_falling",
                bool(np.all(np.isfinite(losses)) and losses[-1] < losses[0]),
                f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    model.opt_kernel_params = False
    t0 = time.perf_counter()
    model.refresh_basis()
    rep.num("A", f"refresh_basis wall {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    res2 = model.optimize(optimizer="adam", max_iters=steps, learning_rate=0.05)
    rep.num("A", f"optimize({steps} reweight steps) wall {time.perf_counter() - t0:.3f} s (compile included)")
    l2 = np.asarray(res2.losses)
    rep.require("A", "reweight_loss_finite_and_falling",
                bool(np.all(np.isfinite(l2)) and l2[-1] < l2[0]),
                f"loss {l2[0]:.4f} -> {l2[-1]:.4f}")

    ll1 = model.log_likelihood()
    t0 = time.perf_counter()
    mean, var = model.predict(xte, include_noise=True)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.predict(xte, include_noise=True)
    rep.num("A", f"predict {len(xte)} rows: cold {t_cold:.3f} s, warm {time.perf_counter() - t0:.4f} s")
    rep.require("A", "pred_var_finite_positive",
                bool(np.all(np.isfinite(var)) and np.all(var > 0)),
                f"var range [{float(var.min()):.3e}, {float(var.max()):.3e}]")
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))

    with _on_cpu_f64():
        ref = make(np.float64, params=model.params)
        ll1_ref = ref.log_likelihood()
        ref.opt_kernel_params = False
        ref.refresh_basis()
        mean_ref = ref.predict(xte.astype(np.float64), compute_var=False)
    rmse_ref = float(np.sqrt(np.mean((mean_ref - fte) ** 2)))
    rep.check("A", "nlml_final_vs_cpu_f64_per_row", abs(ll1 - ll1_ref) / n_train,
              tol_nlml, why_nlml)
    rep.num("A", f"NLML init {-ll0:.4f} (f64 {-ll0_ref:.4f}), final {-ll1:.4f} (f64 {-ll1_ref:.4f})")
    rep.num("A", f"test RMSE {rmse:.6f} (CPU f64 at the same params {rmse_ref:.6f})")
    rep.check("A", "rmse_rel_vs_cpu_f64", abs(rmse - rmse_ref) / rmse_ref, 1e-2,
              "f32 posterior mean vs f64 at the same params; 1% leaves room "
              "for f32 rounding in Φ(x*) and the p×p solves")
    ctx["a_model"] = model


# ---------------------------------------------------------------------------
# Phase B — translation checks at real widths
# ---------------------------------------------------------------------------


def _kron_oracle(factors, v):
    x = np.asarray(v, np.float64).reshape([K.shape[1] for K in factors])
    for i, K in enumerate(factors):
        x = np.moveaxis(np.tensordot(np.asarray(K, np.float64), x, axes=(1, i)), 0, i)
    return x.reshape(-1)


def _b_kron(rep, d, m_d):
    import jax

    import bench
    from gp_grief_jax.ops import kron_matvec_fast
    from gp_grief_jax.ops.kron_fast import GROUP_WIDTH

    fs_np, v_np = bench.kron_inputs(d, m_d)
    ref = _kron_oracle(fs_np, v_np)
    fs = tuple(jax.device_put(f) for f in fs_np)
    v = jax.device_put(v_np)
    copy = bench.measure_copy(v)
    rep.num("B", f"copy of {v.nbytes / 1e6:.1f} MB: {copy['ms']:.4f} ms, {copy['gbs']:.2f} GB/s")
    tols = {
        "DEFAULT": (1e-2, "TF32 products in the wide groups: 10-bit mantissa"),
        "HIGHEST": (1e-5, "exact f32 products"),
    }
    for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST):
        rule = GROUP_WIDTH["fast" if prec == jax.lax.Precision.DEFAULT else "exact"]
        for tw in sorted({1, 128, rule, 1024}):
            r = bench.measure_kron(fs, v, precision=prec, target_width=tw)
            tag = " (default)" if tw == rule else ""
            rep.num(
                "B",
                f"kron {d}x{m_d}^2 {prec.name} target_width={tw}{tag}: "
                f"{r['ms']:.4f} ms, {r['gbs']:.2f} GB/s eff = "
                f"{r['gbs'] / copy['gbs']:.4f} of copy (compile {r['compile_s']:.2f} s)",
            )
            out = jax.jit(
                lambda f, x: kron_matvec_fast(f, x, precision=prec, target_width=tw)
            )(fs, v)
            tol, why = tols[prec.name]
            rep.check("B", f"kron_{d}x{m_d}_{prec.name}_tw{tw}_rel_vs_f64",
                      _rel(out, ref), tol, why)


def _b_phi(rep, ctx, *, p=400):
    import jax
    import jax.numpy as jnp

    from gp_grief_jax.kernels.grief import GriefBasis, phi
    from gp_grief_jax.utils.profiling import time_call

    model = ctx["a_model"]
    kerns, basis, xg, x = model.params["kernels"], model._basis, model.xg, model.x
    n, d = x.shape
    m = int(xg[0].shape[0])
    p = int(basis.idx.shape[0])
    G = jax.device_put(np.random.default_rng(3).standard_normal((n, p)).astype(np.float32))

    def fwd(ks, Qs, lams):
        return phi(GriefBasis(Qs=Qs, lams=lams, log_lam=basis.log_lam, idx=basis.idx), ks, xg, x)

    def loss(ks, Qs, lams):
        return jnp.vdot(fwd(ks, Qs, lams), G)

    args = (kerns, basis.Qs, basis.lams)
    c_f, w_f, Phi = time_call(fwd, *args)
    c_b, w_b, (_, grads) = time_call(jax.value_and_grad(loss, argnums=(0, 1, 2)), *args)
    nbytes = 4 * (d * n * m + 2 * d * n * p + n * p)
    step_s = ctx.get("a_step_s")
    share = f"{w_b / step_s:.4f} of one phase-A step" if step_s else "step not measured"
    rep.num("B", f"phi batched n={n} d={d} m={m} p={p}: fwd {w_f * 1e3:.4f} ms "
                 f"({nbytes / w_f / 1e9:.2f} GB/s by the {nbytes / 1e6:.0f} MB model), "
                 f"fwd+VJP {w_b * 1e3:.4f} ms = {share}; compile {c_f:.2f}+{c_b:.2f} s")
    with _on_cpu_f64():
        args64 = _to(args, np.float64)
        x64 = _to(x, np.float64)
        xg64 = _to(xg, np.float64)
        G64 = _to(G, np.float64)

        def fwd64(ks, Qs, lams):
            b = GriefBasis(Qs=Qs, lams=lams, log_lam=_to(basis.log_lam, np.float64),
                           idx=_to(basis.idx, np.int32))
            return phi(b, ks, xg64, x64)

        Phi_ref = fwd64(*args64)
        g_ref = jax.grad(lambda *a: jnp.vdot(fwd64(*a), G64), argnums=(0, 1, 2))(*args64)
    rep.check("B", "phi_fwd_rel_vs_f64", _rel(Phi, Phi_ref), 1e-5,
              "f32 cross-covariances and einsum at HIGHEST, same basis")
    flat = lambda t: np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in jax.tree.leaves(t)])  # noqa: E731
    rep.check("B", "phi_vjp_rel_vs_f64", _rel(flat(grads), flat(g_ref)), 1e-3,
              "f32 sums over n rows in the cotangent contractions")


def _b_stencil(rep, ms, n):
    import jax
    import jax.numpy as jnp

    import gp_grief_jax.ops.interp_stencil as st_mod
    from gp_grief_jax.ops.interp import build_corner_stream, interp_weights
    from gp_grief_jax.utils.profiling import time_call

    d = 4
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    xg = [np.linspace(-0.05, 1.05, ms, dtype=np.float32)] * d
    iw = interp_weights(x, xg)
    stream = build_corner_stream(iw)
    M = ms**d

    saved = st_mod.DEVICE_BUILD_MIN
    try:
        st_mod.DEVICE_BUILD_MIN = 1 << 62
        t0 = time.perf_counter()
        with _on_cpu_f64():
            host = st_mod.build_wtw_stencil(iw, stream=stream, dtype=np.float64)
            host_tables = np.asarray(host.tables)
        t_host = time.perf_counter() - t0
        st_mod.DEVICE_BUILD_MIN = 0
        t0 = time.perf_counter()
        dev = st_mod.build_wtw_stencil(iw, stream=stream)
        jax.block_until_ready(dev.tables)
        t_dev = time.perf_counter() - t0
    finally:
        st_mod.DEVICE_BUILD_MIN = saved
    rep.num("B", f"stencil tables n={n} on {ms}^{d}: D={len(dev.deltas)}, "
                 f"device build {t_dev:.3f} s (compile included), host f64 build {t_host:.3f} s")
    rep.require("B", "stencil_device_offsets_match_host", dev.deltas == host.deltas,
                f"{len(dev.deltas)} vs {len(host.deltas)} offsets")
    rep.check("B", "stencil_tables_rel_vs_host_f64", _rel(dev.tables, host_tables), 1e-5,
              "f32 atomic scatter-adds of ~2^d·n/M terms per cell, order varies run to run")

    B, iters = 9, 20
    v_np = rng.standard_normal((B, M)).astype(np.float32)
    v = jax.device_put(v_np)

    def chain(tables, u):  # tables as an argument, not a baked constant
        apply = lambda _, w: jax.lax.optimization_barrier(  # noqa: E731
            0.25 * st_mod.wtw_stencil_bm(dev._replace(tables=tables), w))
        return jax.lax.fori_loop(0, iters, apply, u)

    c, t, _ = time_call(chain, dev.tables, v)
    t /= iters
    D = len(dev.deltas)
    nbytes = 4 * (D * M + 2 * B * M)
    rep.num("B", f"stencil apply (_apply_xla) B={B} M={M} D={D}: {t * 1e3:.4f} ms, "
                 f"{nbytes / t / 1e9:.2f} GB/s by the {nbytes / 1e6:.0f} MB model "
                 f"(compile {c:.2f} s)")
    out = jax.jit(lambda tables, u: st_mod.wtw_stencil_bm(dev._replace(tables=tables), u))(
        dev.tables, v)
    with _on_cpu_f64():
        ref = st_mod.wtw_stencil_bm(host._replace(tables=jnp.asarray(host_tables)),
                                    jnp.asarray(v_np, jnp.float64))
    rep.check("B", "stencil_apply_rel_vs_f64", _rel(out, ref), 1e-5,
              "f32 tables and D-term f32 sums")


def _b_wt(rep, ms, n):
    import jax
    import jax.numpy as jnp

    from gp_grief_jax.models.gp_ski import _WINDOWED_MIN_FILL
    from gp_grief_jax.ops.interp import (
        build_corner_stream,
        build_interp_plan,
        interp_rmatvec_bm,
        interp_rmatvec_bm_exact,
        interp_weights,
    )
    from gp_grief_jax.ops.interp_windowed import build_windowed_plan, make_windowed_ops
    from gp_grief_jax.utils.profiling import time_call

    d = 4
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    xg = [np.linspace(-0.05, 1.05, ms, dtype=np.float32)] * d
    iw = interp_weights(x, xg)
    stream = build_corner_stream(iw)
    M = ms**d
    B = 9
    u_np = rng.standard_normal((B, n)).astype(np.float32)
    u = jax.device_put(u_np)
    with _on_cpu_f64():
        iw64 = iw._replace(w=tuple(np.asarray(w, np.float64) for w in iw.w))
        ref = np.asarray(interp_rmatvec_bm(iw64, jnp.asarray(u_np, jnp.float64)))
    plan = build_interp_plan(iw, stream=stream)
    wplan = build_windowed_plan(iw, stream=stream)
    routes = {"ell": lambda uu: interp_rmatvec_bm_exact(plan, uu)}
    if wplan is not None:
        ops = make_windowed_ops(wplan)
        routes["windowed"] = lambda uu: ops[1](uu[:, wplan.perm])
    times = {}
    for name, fn in routes.items():
        c, w, out = time_call(fn, u, reps=10)
        times[name] = w
        rep.num("B", f"W^T {name} n={n} M={M} B={B}: {w * 1e3:.4f} ms (compile {c:.2f} s)")
        rep.check("B", f"wt_{name}_rel_vs_f64", _rel(out, ref), 1e-6,
                  "short f32 sums per cell, same terms as the scatter")
    rule = "windowed" if n >= _WINDOWED_MIN_FILL * M else "ell"
    fastest = min(times, key=times.get)
    rep.num("B", f"W^T at n/M={n / M:.4f}: rule picks {rule}, fastest measured {fastest}")


def phase_b(rep: Report, ctx: dict, *, kron_shapes=((5, 32), (6, 16), (8, 8)), ms=32,
            n_tables=1_000_000, n_wt=100_000) -> None:
    """``kron_shapes``: (d, m_d) lattices for the Kron chain; the first is
    the bench shape, the others carry the grouping rule's narrow factors."""
    for d, m_d in kron_shapes:
        _b_kron(rep, d, m_d)
    if "a_model" in ctx:
        _b_phi(rep, ctx)
    _b_stencil(rep, ms, n_tables)
    _b_wt(rep, ms, n_wt)


# ---------------------------------------------------------------------------
# Phase C — coverage of the other model classes
# ---------------------------------------------------------------------------


def _ski_data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]
    y = (f + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _c_ski(rep, n, ms, solver, tol, **kw):
    import gp_grief_jax as gpx

    d = 4
    x, y = _ski_data(n, d, seed=6 if solver == "lattice" else 7)
    xg = [np.linspace(-0.05, 1.05, ms, dtype=np.float32)[:, None]] * d
    model, t_build = _timed(lambda: gpx.GPSKIRegression(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.3) for _ in range(d)], xg,
        noise_var=0.05, solver=solver, **kw,
    ))
    ll, t_mono = _timed(model.log_likelihood)
    ll2, t_mono2 = _timed(model.log_likelihood)
    seg, t_seg = _timed(model.log_likelihood_segmented)
    tag = f"SKI {solver} n={n} on {ms}^{d}"
    rep.num("C", f"{tag}: build {t_build:.3f} s; NLML cold {t_mono:.3f} s, warm "
                 f"{t_mono2:.3f} s; segmented {t_seg:.3f} s")
    rep.check("C", f"ski_{solver}_nlml_vs_segmented", abs(ll - seg) / abs(seg), tol,
              "same estimator; the two routes draw their SLQ probes in "
              "different chunks, so they agree to the whitened-SLQ sampling residual")
    if solver == "lattice":
        res, t_step = _timed(lambda: model.optimize_segmented(max_iters=1, num_probes=8))
    else:
        res, t_step = _timed(lambda: model.optimize(optimizer="adam", max_iters=1,
                                                    learning_rate=0.05))
    rep.num("C", f"{tag}: one training step {t_step:.3f} s (compile included)")
    rep.require("C", f"ski_{solver}_step_finite",
                bool(np.all(np.isfinite(np.asarray(res.losses)))),
                f"loss {float(np.asarray(res.losses)[-1]):.4f}")


def _c_kron(rep, m):
    import gp_grief_jax as gpx
    from gp_grief_jax.models import GPKroneckerRegression

    rng = np.random.default_rng(8)
    gs = [np.linspace(0, 1, m)[:, None], np.linspace(0, 2, m)[:, None],
          np.linspace(-1, 1, m)[:, None]]
    gs = [g.astype(np.float32) for g in gs]
    pts = np.stack(np.meshgrid(*[g[:, 0] for g in gs], indexing="ij"), -1).reshape(-1, 3)
    y = (np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1]) + 0.3 * pts[:, 2]
         + 0.05 * rng.standard_normal(len(pts))).astype(np.float32)

    def model(solver):
        kerns = [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(3)]
        return GPKroneckerRegression(gs, y, kerns, noise_var=0.05, solver=solver, cg_tol=1e-6)

    ll_s, t_s = _timed(lambda: model("schur").log_likelihood())
    cg = model("cg")
    ll_c, t_c = _timed(cg.log_likelihood)
    rep.num("C", f"Kron grid {m}^3: NLML schur {t_s:.3f} s, cg {t_c:.3f} s (compile included)")
    rep.check("C", "kron_cg_vs_schur", abs(ll_c - ll_s) / abs(ll_s), 1e-4,
              "exact log-det on both routes; CG to 1e-6 relative residual in f32")
    res, t_step = _timed(lambda: cg.optimize(optimizer="adam", max_iters=1, learning_rate=0.05))
    rep.num("C", f"Kron grid {m}^3 cg: one training step {t_step:.3f} s (compile included)")
    rep.require("C", "kron_step_finite", bool(np.all(np.isfinite(np.asarray(res.losses)))),
                f"loss {float(np.asarray(res.losses)[-1]):.4f}")


def _c_gp(rep, n):
    import gp_grief_jax as gpx

    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    y = (np.sin(4 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * rng.standard_normal(n)).astype(np.float32)

    def model(solver, **kw):
        return gpx.GPRegression(x, y, gpx.make_kernel("rbf", lengthscale=0.5),
                                noise_var=0.1, solver=solver, **kw)

    ll_ch, t_ch = _timed(lambda: model("cholesky").log_likelihood())
    it = model("iterative", precond_rank=256, num_probes=16, lanczos_iters=40, cg_tol=1e-6)
    ll_it, t_it = _timed(it.log_likelihood)
    rep.num("C", f"GPRegression n={n}: NLML cholesky {t_ch:.3f} s, iterative {t_it:.3f} s "
                 f"(compile included)")
    rep.check("C", "gp_iterative_vs_cholesky", abs(ll_it - ll_ch) / abs(ll_ch), 5e-3,
              "16-probe whitened SLQ log-det against an exact f32 Cholesky")
    res, t_step = _timed(lambda: it.optimize(optimizer="adam", max_iters=1, learning_rate=0.05))
    rep.num("C", f"GPRegression iterative n={n}: one training step {t_step:.3f} s (compile included)")
    rep.require("C", "gp_step_finite", bool(np.all(np.isfinite(np.asarray(res.losses)))),
                f"loss {float(np.asarray(res.losses)[-1]):.4f}")


def phase_c(rep: Report, ctx: dict, *, ski_lattice_n=1_000_000, ski_data_n=100_000,
            ms=32, kron_m=22, gp_n=1 << 15, ski_tol=1e-3) -> None:
    """``ski_tol``: SKI NLML agreement between the monolithic and segmented
    routes — their SLQ probe draws differ, and the whitened estimator's
    spread shrinks with the points per cell (tiny rehearsals need more)."""
    _c_ski(rep, ski_lattice_n, ms, "lattice", ski_tol, train_mixed16=True, num_probes=8,
           lanczos_iters=30, cg_iters=300, cg_tol=1e-6)
    _c_ski(rep, ski_data_n, ms, "data", ski_tol, num_probes=16, lanczos_iters=40,
           cg_iters=500, cg_tol=1e-6)
    _c_kron(rep, kron_m)
    _c_gp(rep, gp_n)


# ---------------------------------------------------------------------------
# --multichip — the sharded models on four cards
# ---------------------------------------------------------------------------


def phase_multichip(rep: Report, ctx: dict, *, n=2_000_000, mbar=10, p=400, steps=3,
                    ski_n=1_000_000, ms=32, kron_m=64, n_devices=4) -> None:
    import jax

    import gp_grief_jax as gpx
    from benchmarks.data import synthetic_uci2m
    from gp_grief_jax.models import GPKroneckerRegression
    from gp_grief_jax.parallel import ShardedGPGriefModel, ShardedGPSKIRegression, make_mesh

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"needs {n_devices} devices, have {len(jax.devices())}")
    mesh = make_mesh((n_devices,), ("data",))
    rep.num("M", f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    x, y, _ = synthetic_uci2m(np.float32, n=n)
    grid = gpx.InducingGrid.build(x[: min(n, 200_000)], mbar=mbar)
    kern = gpx.make_kernel("rbf", lengthscale=1.0, input_dim=1)
    kw = dict(n_eigs=p, noise_var=0.2, dtype=np.float32)
    single, t1 = _timed(lambda: gpx.GPGriefModel(x, y, kern, grid, **kw))
    ll1, t1b = _timed(single.log_likelihood)
    sh = ShardedGPGriefModel(x, y, kern, grid, mesh=mesh, **kw)
    ll_sh, t_sh = _timed(sh.log_likelihood)
    rep.num("M", f"GRIEF n={n} p={p}: single-card build+NLML {t1 + t1b:.3f} s, "
                 f"sharded NLML {t_sh:.3f} s (compile included)")
    rep.check("M", "grief_sharded_vs_single", abs(ll_sh - ll1) / abs(ll1), 1e-4,
              "same f32 Φ rows; the psum of per-card Grams reorders the n-term sums")
    res, t_tr = _timed(lambda: sh.optimize(optimizer="adam", max_iters=steps, learning_rate=0.05))
    losses = np.asarray(res.losses)
    rep.num("M", f"sharded GRIEF: {steps} Adam steps {t_tr:.3f} s (compile included)")
    rep.require("M", "grief_sharded_steps_finite", bool(np.all(np.isfinite(losses))),
                f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    d = 4
    xs, ys = _ski_data(ski_n, d, seed=6)
    xg = [np.linspace(-0.05, 1.05, ms, dtype=np.float32)[:, None]] * d
    kerns = [gpx.make_kernel("rbf", lengthscale=0.3) for _ in range(d)]
    skw = dict(noise_var=0.05, solver="lattice", num_probes=8, lanczos_iters=30,
               cg_iters=300, cg_tol=1e-6)
    ll_ski1, t_a = _timed(lambda: gpx.GPSKIRegression(xs, ys, kerns, xg, **skw).log_likelihood())
    ll_skis, t_b = _timed(lambda: ShardedGPSKIRegression(
        xs, ys, kerns, xg, mesh=mesh, **skw).log_likelihood())
    rep.num("M", f"SKI lattice n={ski_n} on {ms}^{d}: single build+NLML {t_a:.3f} s, "
                 f"sharded build+NLML {t_b:.3f} s")
    rep.check("M", "ski_sharded_vs_single", abs(ll_skis - ll_ski1) / abs(ll_ski1), 1e-3,
              "same lattice-dual estimator and probe keys; f32 psum order and "
              "per-shard interpolation plans differ")

    rng = np.random.default_rng(10)
    gs = [np.linspace(0, 1, kron_m, dtype=np.float32)[:, None] for _ in range(3)]
    yk = rng.standard_normal(kron_m**3).astype(np.float32)
    kk = [gpx.make_kernel("rbf", lengthscale=0.3) for _ in range(3)]
    kkw = dict(noise_var=0.3, solver="cg", cg_tol=1e-6)
    ll_k1, t_c = _timed(lambda: GPKroneckerRegression(gs, yk, kk, **kkw).log_likelihood())
    ll_kp, t_d = _timed(lambda: GPKroneckerRegression(
        gs, yk, kk, mesh=mesh, model_axis="data", **kkw).log_likelihood())
    rep.num("M", f"Kron cg grid {kron_m}^3: single NLML {t_c:.3f} s, "
                 f"model-parallel NLML {t_d:.3f} s (compile included)")
    rep.check("M", "kron_sharded_vs_single", abs(ll_kp - ll_k1) / abs(ll_k1), 1e-4,
              "exact log-det on both; CG to 1e-6 with reduce-scattered matvecs")


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def run_gpu_tests() -> bool:
    """Phase D: the ``gpu``-marked tests in a child process (this process
    has not touched JAX yet).  True iff all of them ran and passed."""
    env = dict(os.environ, GP_GRIEF_TEST_GPU="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join("tests", "test_gpu.py"),
         "-m", "gpu", "-q", "-p", "no:cacheprovider", "-rs"],
        cwd=ROOT, env=env, capture_output=True, text=True,
    )
    tail = [l for l in proc.stdout.splitlines() if l.strip()][-3:]
    for line in tail:
        print(f"[D] {line}", flush=True)
    ok = proc.returncode == 0 and "skipped" not in proc.stdout and " passed" in proc.stdout
    if not ok and proc.stderr:
        print(proc.stderr[-2000:], file=sys.stderr, flush=True)
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    multichip = "--multichip" in argv
    if not multichip and not run_gpu_tests():
        print("[D] gpu-marked tests did not all run and pass", file=sys.stderr)
        return 1

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}", file=sys.stderr)
        return 1
    n_need = 4 if multichip else 1
    if len(jax.devices()) < n_need:
        print(f"needs {n_need} GPUs, JAX sees {len(jax.devices())}", file=sys.stderr)
        return 1

    from gp_grief_jax.utils import enable_compilation_cache
    from gp_grief_jax.utils.profiling import card_line, device_record

    cache = enable_compilation_cache()
    rep = Report(card_line())
    dev = device_record()
    print(f"card: {rep.card}", flush=True)
    print(f"jax {jax.__version__}; device_kind {dev['kind']}; device count "
          f"{dev['count']}; compilation cache {cache}", flush=True)

    phases = (
        [("M", phase_multichip)]
        if multichip
        else [("A", phase_a), ("B", phase_b), ("C", phase_c)]
    )
    ctx: dict = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(rep, ctx)
        except Exception:
            traceback.print_exc()
            rep.failures.append(f"{name}: raised")
        rep.num(name, f"phase wall {time.perf_counter() - t0:.3f} s")
    for i, d in enumerate(jax.devices()):
        stats = d.memory_stats() or {}
        rep.num("mem", f"device {i} peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}")
    if rep.failures:
        print(f"FAILED: {', '.join(rep.failures)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
