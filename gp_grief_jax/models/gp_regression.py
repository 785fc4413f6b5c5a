"""Exact GP regression — the framework's parity oracle and small-n model.

Re-design of the reference's ``GPRegression`` (reference:
``gp_grief/models.py``, class ``GPRegression`` — SURVEY.md §2 #16): zero-mean
GP with Gaussian noise, NLML via Cholesky, predictive mean/variance via
triangular solves.  The NLML is a pure jitted function of the hyperparameter
pytree; ``jax.grad`` replaces the reference's finite differences.

For large n the Cholesky is replaced by the iterative path: CG solves for the
quadratic term/predictions and SLQ for the log-det (``solver="iterative"``,
reference ``linalg.py`` CG + stochastic Lanczos — SURVEY.md §3.2).
"""

from __future__ import annotations

import time
from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gp_grief_jax.kernels.base import inverse_positive
from gp_grief_jax.kernels.diag import cov_diag
from gp_grief_jax.kernels.grid import product_cov
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.models.base import BaseModel, check_xy
from gp_grief_jax.ops.batching import safe_batch_op
from gp_grief_jax.ops.cg import cg_solve
from gp_grief_jax.ops.lanczos import slq_logdet
from gp_grief_jax.ops.precond import (
    lowrank_sqrt_ops_from_factor,
    pivoted_cholesky,
    pivoted_cholesky_matfree,
)
from gp_grief_jax.ops.solve import logdet_from_chol

__all__ = ["GPRegression"]

KernelLike = Union[Stationary, Sequence[Stationary]]


def _cov_any(kernels: KernelLike, x, z=None):
    """Gram of a single kernel (any callable kernel object) or a product of
    per-dimension kernels (list/tuple)."""
    if not isinstance(kernels, (list, tuple)):
        return kernels(x, z)
    return product_cov(list(kernels), x, z)


def _auto_matvec_chunk(n: int) -> int:
    """Row-block size of the chunked Gram matvec: ~2^28 block elements
    (1 GB f32 live per scan step), at least 128 rows."""
    return int(max(128, min(8192, (1 << 28) // max(n, 1))))


def make_gram_matvec(
    kernels: KernelLike, x: jax.Array, sigma2, *, chunk: int,
    precision: str = "highest",
):
    """Row-chunked matrix-free matvec ``vv ↦ vv (K + σ²I)`` (``vv``: (B, n)).

    The dense iterative path materializes the (n, n) Gram — device-memory
    capped at ~100k points.  Here a ``lax.scan`` over row blocks
    of ``x`` rebuilds each (chunk, n) Gram slab on the fly (distance +
    matmul fused by XLA per block) and contracts it immediately, so the live
    set is one slab + the (B, n) state: n is bounded by compute, not by an
    O(n²) buffer.

    ``precision``: ``"highest"`` (default — solver-facing dots run exact
    f32, the r5 uci2m mixed-precision lesson; see ``gp_nlml_iterative``) or
    ``"default"`` — the fast operating point: the distance matmuls of the
    slab build AND the contraction run at DEFAULT precision (TF32 tensor-core
    products on the GPU), making this the FAST operator of an
    iterative-refinement pair
    (:func:`gp_grief_jax.ops.cg.cg_solve_refined_segmented` — exact
    residual refreshes restore full solution accuracy, so the perturbed
    operator only affects convergence, never the answer)."""
    n = int(x.shape[0])
    chunk = int(min(chunk, n))
    nb = -(-n // chunk)
    pad = nb * chunk - n
    xb = jnp.pad(x, ((0, pad), (0, 0))).reshape(nb, chunk, x.shape[1])
    if precision not in ("highest", "default"):
        raise ValueError("precision must be 'highest' or 'default'")
    prec = (
        jax.lax.Precision.HIGHEST
        if precision == "highest"
        else jax.lax.Precision.DEFAULT
    )

    def mv(vv):
        # Dtype-stable operator: the output dtype is fixed by (data, state)
        # — NOT by the hyperparameters.  Under x64 test configs the kernel
        # params are float64 over float32 data; letting them promote the
        # output would feed a wider dtype back into the solvers' scan
        # carries (measured TypeError inside _cg_fixed).  bf16 solver state
        # over f32 data correctly yields f32 (accumulate-wider).
        od = jnp.result_type(x.dtype, vv.dtype)

        # Rematerialize the Gram slab under differentiation: without it,
        # jax.grad of a scan saves every (chunk, n) cov block (plus its
        # distance intermediates) for the backward pass — O(n²) residual
        # memory, exactly the buffer this operator exists to avoid.  With
        # checkpoint the backward recomputes each slab (cheap: one block
        # cov + matmul) and the live set stays O(chunk·n).
        @jax.checkpoint
        def body_fn(vv_, xblk):
            with jax.default_matmul_precision(precision):
                Kb = _cov_any(kernels, xblk, x)  # (chunk, n)
                return jnp.matmul(vv_, Kb.T, precision=prec).astype(od)

        def body(_, xblk):
            return None, body_fn(vv, xblk)

        _, outs = lax.scan(body, None, xb)  # (nb, B, chunk)
        out = jnp.moveaxis(outs, 0, 1).reshape(vv.shape[0], nb * chunk)[:, :n]
        sig = jnp.asarray(sigma2).astype(od)
        return out + sig * vv.astype(od)

    return mv


def _gram_row_fn(kernels: KernelLike, x: jax.Array):
    """``row_fn(i) -> K[i, :]`` for :func:`pivoted_cholesky_matfree`."""

    def row(piv):
        xi = lax.dynamic_slice_in_dim(x, piv, 1, axis=0)  # (1, d)
        with jax.default_matmul_precision("highest"):
            return _cov_any(kernels, xi, x)[0]

    return row


def gp_nlml(kernels: KernelLike, log_noise, x, y) -> jax.Array:
    """Exact NLML: ``½ yᵀK̃⁻¹y + ½log|K̃| + (n/2)log 2π``, ``K̃ = K + σ²I``."""
    n = x.shape[0]
    K = _cov_any(kernels, x)
    sigma2 = jnp.exp(log_noise)
    L = jnp.linalg.cholesky(K + sigma2 * jnp.eye(n, dtype=K.dtype))
    a = jax.scipy.linalg.solve_triangular(L, y, lower=True)
    return 0.5 * (jnp.sum(a**2) + logdet_from_chol(L) + n * jnp.log(2.0 * jnp.pi))


def gp_nlml_iterative(
    kernels: KernelLike,
    log_noise,
    x,
    y,
    *,
    key,
    num_probes: int = 32,
    lanczos_iters: int = 64,
    cg_tol: float = 1e-8,
    cg_iters: int = 1000,
    precond_rank: int = 0,
    matvec_chunk: int = 0,
    mixed16: bool = False,
) -> jax.Array:
    """Large-n NLML: CG quadratic form + SLQ log-det, BBMM-style gradients.

    ``matvec_chunk > 0`` switches to the MATRIX-FREE operator
    (:func:`make_gram_matvec`): the (n, n) Gram is never materialized; each
    CG/SLQ matvec rebuilds (chunk, n) slabs on the fly, and the pivoted-
    Cholesky preconditioner is built from ``rank`` single kernel rows
    (:func:`pivoted_cholesky_matfree`).  This is what lets
    ``GPRegression(solver="iterative")`` run at n ≥ 500k within device
    memory.  ``0`` keeps the dense-Gram operator (faster at
    small n: one build, many matvecs).

    ``precond_rank=r > 0`` enables the GPyTorch-style pivoted-Cholesky
    preconditioner (PAPERS.md): ``K ≈ L Lᵀ`` with ``L (n, r)`` greedy on the
    largest remaining diagonal, ``M = LLᵀ + σ²I``.  CG runs with the spectral
    ``M⁻¹`` hook and the log-det becomes *whitened SLQ*
    ``log|M| (exact) + log|M⁻½ÃM⁻½|`` — smooth-kernel Grams are routinely
    κ ≳ 1/ε_f32 at large n, where unpreconditioned f32 CG/SLQ silently fail
    (the SKI conditioning analysis applies verbatim to the dense
    operator).  The preconditioner is value-only (built under
    ``stop_gradient``); gradients flow through the BBMM surrogates as before.

    Gradients do NOT flow through the Lanczos recurrence (noisy/biased).
    Instead the value carries stop-gradient surrogates whose autodiff yields
    the exact stochastic identities (GPyTorch BBMM, PAPERS.md):

        ∂ yᵀÃ⁻¹y      = −αᵀ (∂Ã) α,                α  = Ã⁻¹y   (CG)
        ∂ log|Ã|       = tr(Ã⁻¹ ∂Ã) ≈ (1/R) Σ_r s_rᵀ (∂Ã) z_r,  s_r = Ã⁻¹z_r

    One batched CG solves for ``[y, z_1..z_R]`` simultaneously; SLQ supplies
    the log-det *value* only.
    """
    n = x.shape[0]
    sigma2 = jnp.exp(log_noise)

    # Batch-major operator (vv (B, n) rows; K symmetric) — see
    # ops/cg.py:_reducers.  HIGHEST: a low-precision (TF32/bf16) product
    # breaks the SPD-consistency solver iterations need (the uci2m
    # whitening lesson applies verbatim here).
    # TWO operator instances per precision: a LIVE-params one for the BBMM
    # gradient surrogates (quad correction, Hutchinson term — those matvecs
    # ARE differentiated, one checkpointed sweep each), and a STOP-GRADIENT
    # one for every solver/SLQ application.  The solves are value-only by
    # design (solutions are stop-gradiented below), but if their operators
    # close over live params, reverse-mode partial evaluation still
    # linearizes the solver loops — and JVP-of-scan saves the per-block Gram
    # slabs as STACKED residuals: one (nb, n, chunk) buffer, the O(n²)
    # allocation the matrix-free operator exists to avoid (measured 64 GB
    # compile-time OOM at n=2¹⁷/chunk=2048, round-5).  Stop-grad operators
    # keep the solves fully primal: nothing is linearized, nothing stacks.
    kern_sg = jax.tree.map(lax.stop_gradient, kernels)
    sigma2_sg = lax.stop_gradient(sigma2)
    if matvec_chunk > 0:
        mv = make_gram_matvec(kernels, x, sigma2, chunk=matvec_chunk)
        mv_solver = make_gram_matvec(kern_sg, x, sigma2_sg, chunk=matvec_chunk)
        # mixed16: fast DEFAULT-precision Gram operator for the CG INNER
        # iterations of cg_solve_refined — solution accuracy is governed by
        # the exact-operator residual refreshes, so the fast operator affects
        # convergence only, never the answer.
        mv_fast = (
            make_gram_matvec(
                kern_sg, x, sigma2_sg, chunk=matvec_chunk, precision="default"
            )
            if mixed16
            else None
        )
    else:
        K = _cov_any(kernels, x)
        K_sg = lax.stop_gradient(K)
        mv_fast = None

        def mv(vv):
            return (
                jnp.matmul(vv, K, precision=jax.lax.Precision.HIGHEST)
                + sigma2 * vv
            )

        def mv_solver(vv):
            return (
                jnp.matmul(vv, K_sg, precision=jax.lax.Precision.HIGHEST)
                + sigma2_sg * vv
            )

    pre = None
    if precond_rank > 0:
        # Value-only: stop_gradient removes the (unused) eigh/cholesky
        # backward graph entirely — its VJP can emit NaN·0 on degenerate
        # spectra even under zero cotangents.
        if matvec_chunk > 0:
            Lpc = pivoted_cholesky_matfree(
                _gram_row_fn(kern_sg, x),
                cov_diag(kern_sg, x),
                min(int(precond_rank), n),
            )
        else:
            Lpc = pivoted_cholesky(K_sg, min(int(precond_rank), n))
        # Cast σ² to the factor's dtype: under x64 test configs log_noise is
        # f64 over f32 data, and a promoting preconditioner would feed f64
        # back into the f32 solver/Lanczos scan carries (TypeError).
        pre = lowrank_sqrt_ops_from_factor(
            Lpc, sigma2_sg.astype(Lpc.dtype), layout="bm"
        )

    z = jax.random.rademacher(key, (num_probes, n), dtype=y.dtype)
    rhs = jnp.concatenate([y[None, :], z], axis=0)
    # Value-only solve (solutions are stop-gradiented below; gradients flow
    # through the BBMM surrogates) — skip the custom_linear_solve wrapper.
    if pre is not None:
        # Solve in the WHITENED basis (Ã⁻¹r = M⁻½ W̃⁻¹ M⁻½ r): data-space
        # PCG freezes whenever σ² < ε_f32·λmax — the deflated directions'
        # curvature sits below the matvec's output rounding (trained-optimum
        # σ² routinely gets there).  The preconditioner
        # is stop-grad, so the gradient surrogates below are unaffected.
        # safe_batch_op: B = 1+num_probes (33 by default) is one of the
        # padded extents (ops/batching.py).
        M_inv_sqrt_ = pre[1]
        white = safe_batch_op(lambda vv: M_inv_sqrt_(mv_solver(M_inv_sqrt_(vv))))
        if mv_fast is not None:
            from gp_grief_jax.ops.cg import cg_solve_refined

            white_fast = safe_batch_op(
                lambda vv: M_inv_sqrt_(mv_fast(M_inv_sqrt_(vv)))
            )
            # implicit_diff=False: the solutions are stop-gradiented below
            # (BBMM surrogates carry the gradient), and custom_linear_solve
            # would hoist the scan-rebuilt Gram slabs into one O(n²) stacked
            # constant (see cg_solve_refined's docstring — measured 64 GB
            # compile-time allocation at n=2¹⁷).
            solw = cg_solve_refined(
                white_fast, white, M_inv_sqrt_(rhs), tol=cg_tol,
                inner_iters=25, max_restarts=max(1, cg_iters // 25),
                layout="bm", state_dtype=jnp.bfloat16, implicit_diff=False,
            )
        else:
            solw = cg_solve(
                white, M_inv_sqrt_(rhs), tol=cg_tol, max_iters=cg_iters,
                layout="bm", implicit_diff=False,
            )
        sol = M_inv_sqrt_(solw)
    else:
        if mv_fast is not None:
            from gp_grief_jax.ops.cg import cg_solve_refined

            # implicit_diff=False: same O(n²)-hoist avoidance as the
            # preconditioned branch above.
            sol = cg_solve_refined(
                safe_batch_op(mv_fast), safe_batch_op(mv_solver), rhs, tol=cg_tol,
                inner_iters=25, max_restarts=max(1, cg_iters // 25),
                layout="bm", state_dtype=jnp.bfloat16, implicit_diff=False,
            )
        else:
            sol = cg_solve(safe_batch_op(mv_solver), rhs, tol=cg_tol,
                           max_iters=cg_iters, layout="bm",
                           implicit_diff=False)
    alpha = lax.stop_gradient(sol[0])
    S = lax.stop_gradient(sol[1:])

    # Quadratic term surrogate: value yᵀα, gradient −αᵀ(∂Ã)α.
    quad = 2.0 * jnp.dot(y, alpha) - jnp.dot(alpha, mv(alpha[None, :])[0])

    # Log-det: SLQ value (stop-grad) + Hutchinson-gradient surrogate.
    # With a preconditioner, SLQ runs whitened: the clustered spectrum of
    # M⁻½ÃM⁻½ converges in a handful of quadrature nodes.
    if pre is not None:
        M_inv_sqrt, ld_off = pre[1], pre[2]
        slq_mv = safe_batch_op(lambda vv: M_inv_sqrt(mv_solver(M_inv_sqrt(vv))))
    else:
        slq_mv, ld_off = safe_batch_op(mv_solver), 0.0
    ld_val = lax.stop_gradient(
        ld_off
        + slq_logdet(
            slq_mv, n, key=jax.random.fold_in(key, 1), num_probes=num_probes,
            lanczos_iters=lanczos_iters, dtype=y.dtype, layout="bm",
        )
    )
    g_sur = jnp.sum(S * mv(z)) / num_probes
    ld = ld_val + g_sur - lax.stop_gradient(g_sur)

    return 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))


class GPRegression(BaseModel):
    """Exact GP regression (reference API: ``GPRegression(x, y, kernel, noise_var)``)."""

    def __init__(
        self,
        x,
        y,
        kernel: KernelLike,
        noise_var: float = 1.0,
        *,
        solver: str = "cholesky",
        num_probes: int = 32,
        lanczos_iters: int = 64,
        cg_tol: float = 1e-8,
        cg_iters: int = 1000,
        precond_rank: int = 0,
        matvec_chunk="auto",
        mixed16: bool = False,
        key=None,
    ):
        """``solver``: ``"cholesky"`` (exact, O(n³)) or ``"iterative"``
        (CG + SLQ — the reference's large-n path, SURVEY.md §3.2).
        ``precond_rank``: rank of the pivoted-Cholesky preconditioner for the
        iterative path (0 = off); see :func:`gp_nlml_iterative`.

        ``matvec_chunk``: ``"auto"`` (dense Gram up to n=32768, matrix-free
        row-chunked matvecs beyond — the (n, n) buffer never exists), an int
        row-block size to force the matrix-free operator, or ``0`` to force
        the dense Gram.  See :func:`make_gram_matvec`.

        ``mixed16``: the segmented iterative NLML's CG inner iterations run
        the fast Gram operator (``precision="default"`` slab rebuild)
        under exact-residual refinement
        (:func:`gp_grief_jax.ops.cg.cg_solve_refined_segmented`) — the
        quadratic term stays exact-grade while the inner applies run on the
        tensor cores.  SLQ keeps the exact operator (no refinement
        umbrella for a log-det).  Affects
        :meth:`log_likelihood_iterative_segmented` only.

        The iterative objective holds its probe set fixed across optimizer
        steps (sample-average approximation): the optimized surface is
        deterministic and ``fit``'s convergence checks stay meaningful;
        pass a fresh ``key`` between ``optimize`` calls to redraw."""
        x, y = check_xy(x, y)
        if solver not in ("cholesky", "iterative"):
            raise ValueError("solver must be 'cholesky' or 'iterative'")
        self.x, self.y = x, y
        self.solver = solver
        n = int(x.shape[0])
        if matvec_chunk == "auto":
            matvec_chunk = 0 if n <= 32768 else _auto_matvec_chunk(n)
        self._iter_opts = dict(
            num_probes=num_probes, lanczos_iters=lanczos_iters,
            cg_tol=cg_tol, cg_iters=cg_iters, precond_rank=precond_rank,
            matvec_chunk=int(matvec_chunk), mixed16=bool(mixed16),
        )
        self._key = jax.random.PRNGKey(0) if key is None else key
        # Parameter leaves in the data's float dtype: f64 hyperparameters
        # over f32 data would promote solver carries to f64 under x64.
        wdt = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.result_type(float)
        self.params = {
            "kernel": jax.tree.map(lambda a: jnp.asarray(a, dtype=wdt), kernel),
            "log_noise": jnp.asarray(inverse_positive(noise_var), dtype=wdt),
        }

    @property
    def noise_var(self) -> float:
        return float(jnp.exp(self.params["log_noise"]))

    def _loss(self, params):
        if self.solver == "iterative":
            return gp_nlml_iterative(
                params["kernel"], params["log_noise"], self.x, self.y,
                key=self._key, **self._iter_opts,
            )
        return gp_nlml(params["kernel"], params["log_noise"], self.x, self.y)

    def log_likelihood_iterative_segmented(
        self,
        *,
        key=None,
        cg_segment_iters: int = 50,
        probe_chunk: int = 8,
        slq_iter_segment=None,
        fuse_probes=None,
        verbose: bool = False,
        **overrides,
    ) -> float:
        """Segmented iterative NLML: the same CG + (whitened) SLQ estimator
        as the ``solver="iterative"`` loss, executed as a HOST loop of
        bounded device programs (``cg_segment_iters`` CG iterations or
        ``probe_chunk`` SLQ probes each) — the pattern of
        ``GPGriefModel.log_likelihood_iterative_segmented``.

        Value-only (no gradients); ``overrides`` replace any of the
        constructor's iterative options (``num_probes``, ``lanczos_iters``,
        ``cg_tol``, ``cg_iters``, ``precond_rank``, ``matvec_chunk``).

        ``slq_iter_segment``: segment the SLQ Lanczos RECURRENCE itself
        (``iter_segment`` of :func:`ops.lanczos.slq_logdet_segmented`) —
        required at scales where ONE matrix-free matvec costs seconds
        (n=500k: a whole ``lanczos_iters``-deep probe chunk is one very
        long program even at probe_chunk=1).  Pair with a small
        ``cg_segment_iters`` at those scales.

        ``fuse_probes``: advance the CG solve through the SLQ probe phase's
        operator applications (:func:`gp_grief_jax.ops.fused.
        fused_cg_slq_segmented`) — the Gram-slab rebuild is FLAT in the
        batch size, so the fused ``(1+R, n)`` applies make the total Gram
        sweeps ~max(CG, SLQ) instead of their sum (the dominant cost at
        n ≥ 500k, where SLQ is ≈24 of ~40 sweeps).  ``None`` (default)
        fuses unless ``mixed16`` is active (the fused phase must run the
        EXACT operator — the SLQ-bias rule — which would idle the bf16
        fast operator; explicit ``True`` overrides and runs exact)."""
        from gp_grief_jax.ops.cg import cg_solve_segmented
        from gp_grief_jax.ops.lanczos import slq_logdet_segmented
        from gp_grief_jax.ops.precond import lowrank_sqrt_ops_from_factor

        o = {**self._iter_opts, **overrides}
        if key is None:
            key = self._key
        n = int(self.x.shape[0])
        kern = self.params["kernel"]
        sigma2 = jnp.exp(self.params["log_noise"])
        chunk = int(o["matvec_chunk"]) or _auto_matvec_chunk(n)
        mv = make_gram_matvec(kern, self.x, sigma2, chunk=chunk)
        # mixed16: a SECOND Gram operator at the fast point ("default"
        # precision slab rebuild) runs
        # the CG *inner* iterations under exact-residual refinement
        # (cg_solve_refined_segmented) — solution accuracy is governed by
        # the exact refreshes, so the quadratic term is exact-grade.  SLQ
        # keeps the EXACT operator by default: a ~1e-3 operator perturbation
        # biases log|Ã| by ~tr(Ã⁻¹E) with no refinement umbrella to remove
        # it.  ``mixed16_slq=True`` (opt-in, requires mixed16) runs the SLQ
        # probes on the fast operator too — the SLQ applies DOMINATE the
        # matrix-free NLML (≈24 of ~40 total Gram sweeps at the 500k
        # config), so this is where the large-n wall-clock lives.  MEASURED:
        # the bias is CATASTROPHIC at smooth-RBF configs — n=2¹⁷ NLML
        # 62019 → −46242 (rel 1.75; the low-precision apply's
        # absolute error ∝ λmax swamps the whitened spectrum, same mechanism
        # as the r5 "deflation+mixed don't compose" rule) — while plain
        # ``mixed16`` was EXACT (rel 0.0) at 2.13×.  Kept opt-in for
        # operators with modest κ only; warns at use.
        mixed16 = bool(o.get("mixed16", False))
        mixed16_slq = bool(o.get("mixed16_slq", False)) and mixed16
        # Fused CG+SLQ by default (exact operator; the bf16 fast operator
        # has no role inside the fused phase), unless mixed16 asked for the
        # refined-CG path explicitly.
        fuse = (not mixed16) if fuse_probes is None else bool(fuse_probes)
        if mixed16_slq:
            import warnings

            if fuse:
                warnings.warn(
                    "mixed16_slq has no effect with fuse_probes=True: the "
                    "fused phase always runs SLQ on the EXACT operator",
                    stacklevel=2,
                )
                mixed16_slq = False
            else:
                warnings.warn(
                    "mixed16_slq runs SLQ on the bf16 operator: measured "
                    "NLML bias is catastrophic on smooth-kernel Grams "
                    "(rel ~1.8 at n=2^17) — trust it only "
                    "after measuring your operator's spectrum",
                    stacklevel=2,
                )
        mv_fast = (
            make_gram_matvec(
                kern, self.x, sigma2, chunk=chunk, precision="default"
            )
            if mixed16
            else None
        )
        max_segments = max(1, -(-int(o["cg_iters"]) // int(cg_segment_iters)))
        r = int(min(o["precond_rank"], n))
        if r > 0:
            # One bounded prep program: r kernel rows, O(n·r) work.  x is an
            # explicit argument (closure-capture rule, utils/closure).
            Lpc = jax.jit(
                lambda kern, x: pivoted_cholesky_matfree(
                    _gram_row_fn(kern, x), cov_diag(kern, x), r
                )
            )(kern, self.x)
            # Data-dtype preconditioner: under x64 sessions the f64 kernel
            # params over f32 data would otherwise promote the whitened
            # operator's output and break the f32 solver/Lanczos scan
            # carries.
            _, M_inv_sqrt, logdet_M = lowrank_sqrt_ops_from_factor(
                Lpc.astype(self.y.dtype),
                jnp.asarray(sigma2).astype(self.y.dtype),
                layout="bm",
            )

            mv_white = safe_batch_op(
                lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))
            )

            vt = M_inv_sqrt(self.y[None, :])
            if fuse:
                from gp_grief_jax.ops.fused import fused_cg_slq_segmented

                gam, ld_w, _ = fused_cg_slq_segmented(
                    mv_white, vt, n, key, num_probes=int(o["num_probes"]),
                    lanczos_iters=int(o["lanczos_iters"]),
                    probe_chunk=probe_chunk, iter_segment=slq_iter_segment,
                    cg_tol=float(o["cg_tol"]), cg_iters=int(o["cg_iters"]),
                    cg_segment_iters=int(cg_segment_iters), verbose=verbose,
                )
                quad = float(jnp.sum(vt * gam))
                ld = float(logdet_M) + ld_w
            elif mixed16:
                from gp_grief_jax.ops.cg import cg_solve_refined_segmented

                mv_white_fast = safe_batch_op(
                    lambda vv: M_inv_sqrt(mv_fast(M_inv_sqrt(vv)))
                )
                gam = cg_solve_refined_segmented(
                    mv_white_fast, mv_white, vt, tol=o["cg_tol"],
                    inner_iters=int(cg_segment_iters),
                    max_restarts=max_segments, layout="bm", verbose=verbose,
                    state_dtype=jnp.bfloat16,
                )
            else:
                gam = cg_solve_segmented(
                    mv_white, vt, tol=o["cg_tol"],
                    segment_iters=int(cg_segment_iters),
                    max_segments=max_segments, layout="bm", verbose=verbose,
                )
            if not fuse:
                quad = float(jnp.sum(vt * gam))
                slq_op = mv_white_fast if mixed16_slq else mv_white
                ld = float(logdet_M) + slq_logdet_segmented(
                    slq_op, n, key=key, num_probes=o["num_probes"],
                    lanczos_iters=o["lanczos_iters"], dtype=self.y.dtype,
                    layout="bm", probe_chunk=probe_chunk,
                    iter_segment=slq_iter_segment,
                )
        else:
            # safe_batch_op: the SLQ probe batch (probe_chunk rows) need not
            # be 8-aligned (ops/batching.py).
            mv_safe = safe_batch_op(mv)
            rhs = self.y[None, :]
            if fuse:
                from gp_grief_jax.ops.fused import fused_cg_slq_segmented

                alpha, ld, _ = fused_cg_slq_segmented(
                    mv_safe, rhs, n, key, num_probes=int(o["num_probes"]),
                    lanczos_iters=int(o["lanczos_iters"]),
                    probe_chunk=probe_chunk, iter_segment=slq_iter_segment,
                    cg_tol=float(o["cg_tol"]), cg_iters=int(o["cg_iters"]),
                    cg_segment_iters=int(cg_segment_iters), verbose=verbose,
                )
                quad = float(jnp.sum(rhs * alpha))
            elif mixed16:
                from gp_grief_jax.ops.cg import cg_solve_refined_segmented

                alpha = cg_solve_refined_segmented(
                    safe_batch_op(mv_fast), mv_safe, rhs, tol=o["cg_tol"],
                    inner_iters=int(cg_segment_iters),
                    max_restarts=max_segments, layout="bm", verbose=verbose,
                    state_dtype=jnp.bfloat16,
                )
            else:
                alpha = cg_solve_segmented(
                    mv_safe, rhs, tol=o["cg_tol"],
                    segment_iters=int(cg_segment_iters),
                    max_segments=max_segments, layout="bm", verbose=verbose,
                )
            if not fuse:
                quad = float(jnp.sum(rhs * alpha))
                slq_op = safe_batch_op(mv_fast) if mixed16_slq else mv_safe
                ld = slq_logdet_segmented(
                    slq_op, n, key=key, num_probes=o["num_probes"],
                    lanczos_iters=o["lanczos_iters"], dtype=self.y.dtype,
                    layout="bm", probe_chunk=probe_chunk,
                    iter_segment=slq_iter_segment,
                )
        return -0.5 * (quad + ld + n * float(np.log(2.0 * np.pi)))


    def optimize_segmented(
        self,
        max_iters: int = 10,
        *,
        learning_rate: float = 0.05,
        key=None,
        cg_segment_iters: int = 25,
        probe_grad_chunk: int = 4,
        verbose: bool = False,
        **overrides,
    ):
        """Segmented training at matrix-free scales.

        The monolithic differentiable loss runs one value_and_grad program
        per step — past n ≈ 2¹⁷ that single program runs for tens of
        seconds.  This method decomposes each Adam step into BOUNDED device
        programs, the `GPSKIRegression.optimize_segmented` pattern applied
        to the dense matrix-free operator:

        1. value-only SEGMENTED CG for ``α = Ã⁻¹y`` and ``S_r = Ã⁻¹z_r``
           (one batched (1+R)-rhs solve; whitened when ``precond_rank>0``,
           preconditioner rebuilt per step at the current hypers);
        2. the BBMM surrogate gradient assembled from bounded
           ``value_and_grad`` programs — the quadratic piece
           ``−αᵀ(∂Ã)α`` and the Hutchinson pieces ``Σ s_rᵀ(∂Ã)z_r / R`` in
           ``probe_grad_chunk``-sized chunks, each one forward + one
           rematerialized backward Gram sweep;
        3. an optax Adam update (tiny host-side program).

        The SLQ log-det VALUE is never computed inside a step (the BBMM
        gradient does not need it): ``losses`` traces the data-fit
        surrogate ``½(yᵀα) + (n/2)log 2π`` only — evaluate
        :meth:`log_likelihood_iterative_segmented` before/after training
        for true NLML numbers.  Probes are a fixed SAA draw (same rule as
        the monolithic loss).  ``overrides`` adjust the constructor's
        iterative options.  Returns a :class:`gp_grief_jax.optimize.
        FitResult`; ``self.params`` is updated in place.
        """
        import optax

        from gp_grief_jax.optimize import FitResult
        from gp_grief_jax.ops.cg import cg_solve_segmented
        from gp_grief_jax.ops.lanczos import _probe_chunk_sizes
        from gp_grief_jax.utils.closure import explicit_closure

        o = {**self._iter_opts, **overrides}
        chunk = int(o["matvec_chunk"])
        if self.solver != "iterative" or chunk <= 0:
            raise ValueError(
                "optimize_segmented needs solver='iterative' and a "
                "matrix-free operator (matvec_chunk > 0); use optimize() "
                "for the dense/small-n paths"
            )
        if key is None:
            key = self._key
        n = int(self.x.shape[0])
        R = int(o["num_probes"])
        r = int(min(o["precond_rank"], n))
        dtype = self.y.dtype
        Z = jax.random.rademacher(key, (R, n), dtype=dtype)
        rhs0 = jnp.concatenate([self.y[None, :], Z], axis=0)
        max_segments = max(1, -(-int(o["cg_iters"]) // int(cg_segment_iters)))

        def _mk_mv(params, precision="highest"):
            return make_gram_matvec(
                params["kernel"], self.x, jnp.exp(params["log_noise"]),
                chunk=chunk, precision=precision,
            )

        # Bounded surrogate-grad programs, built ONCE (params explicit).
        p_sds = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
            self.params,
        )
        a_sds = jax.ShapeDtypeStruct((n,), dtype)

        def quad_piece(params, alpha):
            return -jnp.dot(alpha, _mk_mv(params)(alpha[None, :])[0])

        qp, qc = explicit_closure(quad_piece, p_sds, a_sds)
        quad_vg = jax.jit(jax.value_and_grad(qp, argnums=1))

        sizes = _probe_chunk_sizes(R, probe_grad_chunk)
        ld_vgs = {}
        for c in sorted(set(sizes)):
            c_sds = jax.ShapeDtypeStruct((c, n), dtype)

            def ld_piece(params, S_c, Z_c, _c=c):
                mv = _mk_mv(params)
                if _c > 8 and _c % 8:
                    mv = safe_batch_op(mv)
                return jnp.sum(S_c * mv(Z_c)) / R

            lp, lc = explicit_closure(ld_piece, p_sds, c_sds, c_sds)
            ld_vgs[c] = (jax.jit(jax.value_and_grad(lp, argnums=1)), lc)

        pc_prog = None
        if r > 0:
            pc_prog = jax.jit(
                lambda kern, x: pivoted_cholesky_matfree(
                    _gram_row_fn(kern, x), cov_diag(kern, x), r
                )
            )

        opt = optax.adam(learning_rate)
        opt_state = opt.init(self.params)
        losses, gnorms = [], []
        t0 = time.perf_counter()
        for step in range(int(max_iters)):
            params = self.params
            mv = _mk_mv(params)
            # (1) value-only segmented batched solve at the current hypers.
            # NOTE: rebuilding the solve closure retraces its segment
            # program each step (host cost, seconds at n=500k) — the device
            # programs themselves stay bounded.
            if r > 0:
                Lpc = pc_prog(params["kernel"], self.x)
                _, M_inv_sqrt, _ = lowrank_sqrt_ops_from_factor(
                    Lpc.astype(dtype),
                    jnp.exp(params["log_noise"]).astype(dtype),
                    layout="bm",
                )
                white = safe_batch_op(
                    lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))
                )
                solw = cg_solve_segmented(
                    white, M_inv_sqrt(rhs0), tol=float(o["cg_tol"]),
                    segment_iters=int(cg_segment_iters),
                    max_segments=max_segments, layout="bm", verbose=verbose,
                )
                sol = M_inv_sqrt(solw)
            else:
                sol = cg_solve_segmented(
                    safe_batch_op(mv), rhs0, tol=float(o["cg_tol"]),
                    segment_iters=int(cg_segment_iters),
                    max_segments=max_segments, layout="bm", verbose=verbose,
                )
            alpha, S = sol[0], sol[1:]

            # (2) surrogate gradient from bounded pieces.
            v_q, g = quad_vg(qc, params, alpha)
            off = 0
            for c in sizes:
                vg, lc = ld_vgs[c]
                _, g_c = vg(lc, params, S[off : off + c], Z[off : off + c])
                g = jax.tree.map(jnp.add, g, g_c)
                off += c
            g = jax.tree.map(lambda t: 0.5 * t, g)

            # (3) Adam update (host-side pytree math is tiny).
            updates, opt_state = opt.update(g, opt_state, params)
            self.params = optax.apply_updates(params, updates)

            fit_sur = float(
                0.5 * (jnp.dot(self.y, alpha) + n * np.log(2.0 * np.pi))
            )
            gn = float(optax.global_norm(g))
            losses.append(fit_sur)
            gnorms.append(gn)
            if verbose:
                print(
                    f"[optimize_segmented] step {step + 1}/{max_iters}: "
                    f"data-fit {fit_sur:.4f}  |g| {gn:.3e}", flush=True,
                )
        return FitResult(
            params=self.params,
            losses=np.asarray(losses),
            grad_norms=np.asarray(gnorms),
            iterations=int(max_iters),
            wall_time=time.perf_counter() - t0,
            converged=False,
            opt_state=opt_state,
        )

    def predict(
        self,
        x_new,
        compute_var: bool = True,
        include_noise: bool = False,
        chunk: int = 0,
    ):
        """Predictive mean (and variance): ``K_*X K̃⁻¹ y`` / Schur diagonal.

        With the matrix-free operator active (``matvec_chunk > 0`` under
        ``solver="iterative"``) prediction never materializes the (n, n)
        Gram either: ``α`` comes from one segmented CG, then each ``chunk``
        of test points runs one cross-covariance program + one segmented
        multi-rhs CG for the variance columns (a host loop, so arbitrarily
        many test points stay within bounded programs)."""
        x_new = jnp.asarray(x_new)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        if self.solver == "iterative" and self._iter_opts["matvec_chunk"] > 0:
            return self._predict_iterative(
                x_new, compute_var, include_noise, test_chunk=chunk
            )
        if not hasattr(self, "_predict_jit"):

            def _predict(params, x_new):
                kern, log_noise = params["kernel"], params["log_noise"]
                n = self.x.shape[0]
                K = _cov_any(kern, self.x)
                sigma2 = jnp.exp(log_noise)
                L = jnp.linalg.cholesky(K + sigma2 * jnp.eye(n, dtype=K.dtype))
                alpha = jax.scipy.linalg.solve_triangular(
                    L.T,
                    jax.scipy.linalg.solve_triangular(L, self.y, lower=True),
                    lower=False,
                )
                Ks = _cov_any(kern, x_new, self.x)  # (n*, n)
                mean = Ks @ alpha
                A = jax.scipy.linalg.solve_triangular(L, Ks.T, lower=True)  # (n, n*)
                prior_diag = cov_diag(kern, x_new)
                var = prior_diag - jnp.sum(A**2, axis=0)
                return mean, jnp.maximum(var, 0.0), sigma2

            self._predict_jit = jax.jit(_predict)
        mean, var, sigma2 = self._predict_jit(self.params, x_new)
        if not compute_var:
            return np.asarray(mean)
        if include_noise:
            var = var + sigma2
        return np.asarray(mean), np.asarray(var)

    def _kern_fingerprint(self):
        """Value-based fingerprint of the hyperparameters (tiny leaves)."""
        return tuple(
            np.asarray(leaf).tobytes()
            for leaf in jax.tree_util.tree_leaves(self.params)
        )

    def _predict_iterative(
        self, x_new, compute_var: bool, include_noise: bool, *, test_chunk: int = 0
    ):
        """Matrix-free prediction (see :meth:`predict`).  Exact up to CG
        tolerance; memory never holds an (n, n) buffer — the largest live
        arrays are the (chunk, n) cross-covariance block and the CG state.

        The representer solve ``α`` and the preconditioner factor are cached
        per hyperparameter values (serving: repeated predict calls at a
        trained optimum pay only the per-chunk work)."""
        from gp_grief_jax.ops.cg import cg_solve_segmented

        o = self._iter_opts
        n = int(self.x.shape[0])
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = np.zeros((0,), dtype=np.asarray(self.y).dtype)
            return empty if not compute_var else (empty, empty.copy())
        kern = self.params["kernel"]
        sigma2 = jnp.exp(self.params["log_noise"])
        mv = make_gram_matvec(kern, self.x, sigma2, chunk=int(o["matvec_chunk"]))
        seg_iters = 50
        max_segments = max(1, -(-int(o["cg_iters"]) // seg_iters))
        r = int(min(o["precond_rank"], n))
        fp = self._kern_fingerprint()
        cached = getattr(self, "_pred_cache", None)
        Lpc = cached[1] if (cached is not None and cached[0] == fp) else None
        if r > 0:
            from gp_grief_jax.ops.precond import lowrank_sqrt_ops_from_factor

            if Lpc is None:
                Lpc = jax.jit(
                    lambda kern, x: pivoted_cholesky_matfree(
                        _gram_row_fn(kern, x), cov_diag(kern, x), r
                    )
                )(kern, self.x)
            _, M_inv_sqrt, _ = lowrank_sqrt_ops_from_factor(
                Lpc, sigma2, layout="bm"
            )

            def solve_bm(rhs_bm):
                # safe_batch_op: B = test_chunk rows is user-tunable and the
                # auto value need not be 8-aligned (ops/batching.py rule).
                w = cg_solve_segmented(
                    safe_batch_op(lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))),
                    M_inv_sqrt(rhs_bm), tol=o["cg_tol"],
                    segment_iters=seg_iters, max_segments=max_segments,
                    layout="bm",
                )
                return M_inv_sqrt(w)
        else:

            def solve_bm(rhs_bm):
                return cg_solve_segmented(
                    safe_batch_op(mv), rhs_bm, tol=o["cg_tol"],
                    segment_iters=seg_iters,
                    max_segments=max_segments, layout="bm",
                )

        if cached is not None and cached[0] == fp:
            alpha = cached[2]
        else:
            alpha = solve_bm(self.y[None, :])[0]  # (n,) representer weights
            self._pred_cache = (fp, Lpc, alpha)
        if test_chunk <= 0:
            # (chunk, n) cross-cov block + ~5 CG state buffers of the same
            # shape: cap the block at 2^27 elements (512 MB f32 live for the
            # solve).  Rounded to a multiple of 8 so the batched variance
            # solve needs no batch padding (ops/batching.py).
            test_chunk = int(max(8, min(1024, (1 << 27) // max(n, 1))))
            test_chunk -= test_chunk % 8
        test_chunk = min(test_chunk, n_star)
        n_pad = -(-n_star // test_chunk) * test_chunk
        x_pad = (
            jnp.concatenate(
                [x_new, jnp.broadcast_to(x_new[:1], (n_pad - n_star, x_new.shape[1]))]
            )
            if n_pad != n_star
            else x_new
        )

        # x/α travel as jit ARGUMENTS (closure-capture rule).
        def _cross(kern, xc, x, alpha):
            with jax.default_matmul_precision("highest"):
                Ks = _cov_any(kern, xc, x)  # (c, n)
            return Ks, jnp.matmul(
                Ks, alpha, precision=jax.lax.Precision.HIGHEST
            ), cov_diag(kern, xc)

        if not hasattr(self, "_cross_jit"):
            self._cross_jit = jax.jit(_cross)
        means, vars_ = [], []
        for i in range(0, n_pad, test_chunk):
            xc = x_pad[i : i + test_chunk]
            Ks, mean_c, prior_c = self._cross_jit(kern, xc, self.x, alpha)
            if compute_var:
                Z = solve_bm(Ks)  # (c, n) solves of (K+σ²I)⁻¹ K_X*
                var_c = jnp.maximum(prior_c - jnp.sum(Ks * Z, axis=1), 0.0)
            else:
                var_c = jnp.zeros_like(mean_c)
            means.append(np.asarray(mean_c))
            vars_.append(np.asarray(var_c))
        mean = np.concatenate(means)[:n_star]
        var = np.concatenate(vars_)[:n_star]
        if not compute_var:
            return mean
        if include_noise:
            var = var + float(sigma2)
        return mean, var
