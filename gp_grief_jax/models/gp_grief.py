"""GP-GRIEF model: O(n·p + p³) exact inference with grid eigenfunctions.

Re-design of the reference's ``GPGriefModel`` (reference:
``gp_grief/models.py``, class ``GPGriefModel`` — SURVEY.md §2 #17; Evans &
Nair ICML 2018).  The kernel is ``k(x,z) = Σ_j w_j φ_j(x) φ_j(z)`` with the
GRIEF eigenfunction basis (``kernels/grief.py``); NLML and prediction use the
matrix inversion + determinant lemmas (see ``models/base.py``), so after the
one-time O(n·p²) basis reductions every NLML evaluation is O(p³) regardless of
``n`` or the 10^100+ virtual inducing-point count.

Two training regimes (reference flags, SURVEY.md §2 #13/#17):

* ``reweight_eig_funs`` (default): train ``log w`` (p,) and the noise — the
  basis is fixed, ``ΦᵀΦ``/``Φᵀy`` are cached, each step is O(p³).
* ``opt_kernel_params``: also train the base-kernel hyperparameters — the
  whole §3.1 stack (per-dim eigh → top-p selection → Φ → reductions) is traced
  into the objective and differentiated by ``jax.grad`` (the reference
  rebuilds this per finite-difference probe; here it is one reverse-mode pass).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax.grid import InducingGrid
from gp_grief_jax.kernels.base import inverse_positive
from gp_grief_jax.kernels.grief import GriefBasis, build_basis, phi
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.models.base import (
    BaseModel,
    BasisStats,
    basis_nlml,
    basis_posterior,
    check_xy,
    gram,
)

__all__ = ["GPGriefModel", "init_grief_state"]


def init_grief_state(x, y, kern_list, grid, n_eigs, noise_var, mbar, dtype):
    """Shared constructor plumbing for GRIEF-family models (single-chip and
    sharded): coerce data, default the grid, clamp ``n_eigs`` to the
    realizable lattice, broadcast/validate/cast the kernel list, and build the
    parameter pytree.  Returns ``(x, y, grid, xg, n_eigs, dims, params)``."""
    x, y = check_xy(jnp.asarray(x, dtype=dtype), jnp.asarray(y, dtype=dtype))
    if grid is None:
        grid = InducingGrid.build(np.asarray(x), mbar=mbar)
    xg = tuple(jnp.asarray(g, dtype=x.dtype) for g in grid.xg)
    n_eigs = int(n_eigs)
    if grid.log10_num_virtual < 18:  # lattice countable in int64
        n_eigs = min(n_eigs, int(np.prod(grid.grid_shape)))
    dims = getattr(grid, "dims", None)
    if dims is not None and all(len(g) == 1 for g in dims):
        dims = None  # trivial mapping; keep the fast default path
    kerns = (
        list(kern_list)
        if isinstance(kern_list, (list, tuple))
        else [kern_list] * grid.grid_dim
    )
    if len(kerns) != grid.grid_dim:
        raise ValueError(f"need {grid.grid_dim} kernels, got {len(kerns)}")
    # Keep every parameter leaf in the working dtype (f32 on the GPU).
    kerns = jax.tree.map(lambda a: jnp.asarray(a, dtype=x.dtype), kerns)
    params = {
        "log_w": jnp.zeros((n_eigs,), dtype=x.dtype),
        "log_noise": inverse_positive(noise_var).astype(x.dtype),
        "kernels": kerns,
    }
    return x, y, grid, xg, n_eigs, dims, params


class GPGriefModel(BaseModel):
    """Reference API: ``GPGriefModel(x, y, kern_list, grid, n_eigs, noise_var, ...)``."""

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid: Optional[InducingGrid] = None,
        *,
        n_eigs: int = 100,
        noise_var: float = 1.0,
        reweight_eig_funs: bool = True,
        opt_kernel_params: bool = False,
        dim_noise_var: float = 1e-12,
        mbar: int = 10,
        dtype=None,
    ):
        (self.x, self.y, self.grid, self.xg, self.n_eigs, self.dims,
         self.params) = init_grief_state(
            x, y, kern_list, grid, n_eigs, noise_var, mbar, dtype
        )
        self.reweight_eig_funs = bool(reweight_eig_funs)
        self.opt_kernel_params = bool(opt_kernel_params)
        self.dim_noise_var = float(dim_noise_var)
        if not self.opt_kernel_params:
            # Fixed basis: build once, cache the O(n·p²) reductions.
            self._refresh_cache()

    # -- basis plumbing ------------------------------------------------------

    def _build(self, kerns) -> GriefBasis:
        return build_basis(kerns, self.xg, self.n_eigs, dim_noise_var=self.dim_noise_var)

    # Row-chunk size for the one-time O(n·p²) reductions: bounds peak memory
    # at ~chunk·p·(d-ish) floats regardless of n (the 2M-point config would
    # otherwise materialize several (n, p) intermediates at once).
    stats_chunk: int = 131072

    def _stats_from(self, kerns, basis: GriefBasis) -> BasisStats:
        n = self.x.shape[0]
        if n <= self.stats_chunk:
            Phi = phi(basis, kerns, self.xg, self.x, dims=self.dims)
            return BasisStats(
                C=gram(Phi.T, Phi),
                v=gram(Phi.T, self.y),
                yy=jnp.dot(self.y, self.y),
                n=n,
            )
        chunk = self.stats_chunk
        nchunks = -(-n // chunk)
        pad = nchunks * chunk - n
        xp = jnp.pad(self.x, ((0, pad), (0, 0)))
        yp = jnp.pad(self.y, (0, pad))
        mask = jnp.pad(jnp.ones((n,), self.y.dtype), (0, pad))
        xc = xp.reshape(nchunks, chunk, -1)
        yc = (yp * mask).reshape(nchunks, chunk)
        mc = mask.reshape(nchunks, chunk)
        p = basis.idx.shape[0]
        dtype = self.y.dtype

        def body(carry, inp):
            C, v, yy = carry
            xk, yk, mk = inp
            Phik = phi(basis, kerns, self.xg, xk, dims=self.dims) * mk[:, None]
            return (
                C + gram(Phik.T, Phik),
                v + gram(Phik.T, yk),
                yy + jnp.dot(yk, yk),
            ), None

        (C, v, yy), _ = jax.lax.scan(
            body,
            (jnp.zeros((p, p), dtype), jnp.zeros((p,), dtype), jnp.zeros((), dtype)),
            (xc, yc, mc),
        )
        return BasisStats(C=C, v=v, yy=yy, n=n)

    def _kern_fingerprint(self):
        """Value-based fingerprint of the kernel hyperparameters (the only
        params the cached basis/stats depend on).  Kernel leaves are tiny, so
        the host sync is negligible; value comparison catches in-place
        mutation of ``self.params`` and avoids spurious rebuilds after
        reweight-only training (where the kernels are bit-identical)."""
        return tuple(
            np.asarray(leaf).tobytes()
            for leaf in jax.tree_util.tree_leaves(self.params["kernels"])
        )

    def _refresh_cache(self):
        if not hasattr(self, "_build_jit"):
            from gp_grief_jax.utils.closure import explicit_closure

            self._build_jit = jax.jit(self._build)  # captures only xg (tiny)
            # The stats program touches self.x/self.y (n-sized): hoist them
            # into explicit arguments — a bound-method jit would bake the
            # data into the lowered module as constants (utils/closure rule).
            sds = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
                self.params["kernels"],
            )
            basis_sds = jax.eval_shape(self._build, sds)
            pure, consts = explicit_closure(self._stats_from, sds, basis_sds)
            self._stats_jit = (jax.jit(pure), consts)
        self._basis = self._build_jit(self.params["kernels"])
        fn, consts = self._stats_jit
        self._stats = fn(consts, self.params["kernels"], self._basis)
        self._cached_for = self._kern_fingerprint()
        # The NLML jit (BaseModel.log_likelihood) closes over self._stats at
        # trace time; a re-anchored cache must invalidate it.
        self.__dict__.pop("_loss_jit", None)

    def _ensure_cache(self):
        """Build/refresh the cached basis+stats if missing or stale (kernel
        values changed since the last refresh, by replacement OR mutation)."""
        if not hasattr(self, "_basis") or self._cached_for != self._kern_fingerprint():
            self._refresh_cache()

    def log_likelihood(self) -> float:
        if not self.opt_kernel_params:
            self._ensure_cache()  # _loss reads the cached stats
        return super().log_likelihood()

    def refresh_basis(self):
        """Public re-anchor: rebuild the eigenbasis + cached statistics at the
        current hyperparameters (e.g. after loading a checkpoint or switching
        ``opt_kernel_params`` phases)."""
        self._refresh_cache()

    # -- NLML ---------------------------------------------------------------

    def _loss(self, params):
        log_w = params["log_w"]
        if not self.reweight_eig_funs:
            log_w = jax.lax.stop_gradient(log_w)
        if self.opt_kernel_params:
            basis = self._build(params["kernels"])
            stats = self._stats_from(params["kernels"], basis)
        else:
            stats = self._stats
        return basis_nlml(stats, log_w, params["log_noise"])

    def optimize(self, **kwargs):
        if not self.opt_kernel_params:
            # Reweight mode trains log_w/noise against the cached basis/stats;
            # rebuild them first if params['kernels'] was mutated after
            # construction, so training and later predict() share one basis.
            self._ensure_cache()
        res = super().optimize(**kwargs)
        if self.opt_kernel_params:
            self._refresh_cache()  # re-anchor the cached basis at the optimum
        return res

    # -- large-scale iterative path ------------------------------------------

    def kernel_matvec(self, v):
        """``(K̃ + σ²I) v = Φ W Φᵀ v + σ² v`` in O(n·p) — the structured matvec
        that makes CG/Lanczos/SLQ run at the 2M-point scale (BASELINE config 4).
        ``v``: ``(n,)`` or ``(n, B)``."""
        from gp_grief_jax.kernels.grief import phi as _phi

        self._ensure_cache()
        Phi = _phi(self._basis, self.params["kernels"], self.xg, self.x, dims=self.dims)
        w = jnp.exp(self.params["log_w"])
        sigma2 = jnp.exp(self.params["log_noise"])
        squeeze = v.ndim == 1
        vv = v[:, None] if squeeze else v
        out = Phi @ (w[:, None] * (Phi.T @ vv)) + sigma2 * vv
        return out[:, 0] if squeeze else out

    def log_likelihood_iterative(
        self,
        *,
        key=None,
        num_probes: int = 32,
        lanczos_iters: int = 64,
        cg_tol: float = 1e-8,
        cg_iters: int = 1000,
        precond_rank: int = 0,
    ) -> float:
        """NLML via CG (quadratic term) + SLQ (log-det) on the n×n operator.

        The reference's large-n training path (``linalg.py`` CG + stochastic
        Lanczos — SURVEY.md §3.2) driven by the O(n·p) GRIEF matvec.  The
        closed-form O(p³) ``log_likelihood`` is exact and preferred; this
        exists for parity and for very large ``p`` where O(p³) dominates.

        ``precond_rank=r > 0`` enables rank-r deflation built from the top-r
        eigenpairs of ``ΦWΦᵀ`` (obtained from the p×p eigendecomposition of
        ``W^{1/2}ΦᵀΦW^{1/2}`` — O(p³), already cheap): CG runs with the
        Woodbury ``M⁻¹`` hook, and the log-det becomes *preconditioned SLQ*
        ``log|M| (exact) + log|M^{-1/2}ÃM^{-1/2}|`` (whitened spectrum
        clustered at 1 → the quadrature converges in a handful of nodes).
        Measured at n=1.9M/σ²=0.02: NLML gap 2.5% → ~1e-4 grade and CG off
        its iteration cap.
        """
        from gp_grief_jax.kernels.grief import phi as _phi
        from gp_grief_jax.ops.cg import cg_solve
        from gp_grief_jax.ops.lanczos import slq_logdet
        from gp_grief_jax.ops.precond import lowrank_sqrt_ops

        if key is None:
            key = jax.random.PRNGKey(0)
        self._ensure_cache()
        n = self.x.shape[0]
        r = int(min(precond_rank, self.n_eigs))

        def _nlml(params, key):
            Phi = _phi(self._basis, params["kernels"], self.xg, self.x, dims=self.dims)
            w = jnp.exp(params["log_w"])
            sigma2 = jnp.exp(params["log_noise"])

            # Batch-major operator: vv (B, n) rows (ops/cg.py:_reducers).
            # HIGHEST precision: a low-precision (TF32/bf16) matmul gives the
            # operator ~1e-3·λmax SPD-inconsistency — at a trained optimum
            # (σ² ≈ 0.02, n=1.9M) preconditioned f32 CG then diverges within
            # 2 iterations and the breakdown guard freezes it (same rule as
            # every solver-facing matvec).
            hi = jax.lax.Precision.HIGHEST

            def mv(vv):
                t = jnp.matmul(vv, Phi, precision=hi)
                return (
                    jnp.matmul(t * w[None, :], Phi.T, precision=hi)
                    + sigma2 * vv
                )

            if r > 0:
                # Top-r spectral factors of ΦWΦᵀ = B₀B₀ᵀ, B₀ = ΦW^{1/2},
                # via the f32-robust CholeskyQR2 + congruence-eigh build.
                # The analytic shortcut U = B₀V_rΛ_r^{-1/2} (one O(n·p²)
                # Gram + p×p eigh) leaves a ~5e-3 orthonormality defect at
                # n=1.9M — M⁻¹ loses SPD, preconditioned CG diverges and the
                # breakdown guard freezes it after ~3 iterations (measured;
                # the same failure mode as the SKI build).
                from gp_grief_jax.ops.precond import lowrank_spectral_factor

                # weights= hook (NOT Phi*sqrt(w) baked into the factor): the
                # two-stage build orthonormalizes Phi FIRST so the Cholesky
                # sees κ(Φ)² only — baking the weights in re-introduces the
                # w₁/w_r conditioning the build exists to avoid.
                U, lam_r = lowrank_spectral_factor(Phi, weights=w, top_r=r)
                lam_r = jnp.maximum(lam_r, jnp.finfo(lam_r.dtype).tiny)
                # U: (n, r) orthonormal to working eps
                M_inv, M_inv_sqrt, logdet_M = lowrank_sqrt_ops(
                    U, lam_r, sigma2, layout="bm"
                )

                def mv_white(vv):
                    return M_inv_sqrt(mv(M_inv_sqrt(vv)))

                # Solve in the WHITENED basis (yᵀÃ⁻¹y = ṽᵀW̃⁻¹ṽ with
                # ṽ = M^{-1/2}y), not data space: at a trained optimum
                # (σ² ≈ 0.02, λmax ~ 1e6, n=1.9M) the deflated directions'
                # curvature σ²‖p‖² sits BELOW the f32 rounding of the
                # matvec output (ε·λmax·‖p‖²), so data-space PCG's pᵀÃp
                # goes negative within 2 iterations at ANY matvec precision
                # and the breakdown guard freezes a rel-418 iterate
                # (measured).  The whitened operator's arithmetic is bounded
                # per eigendirection — the same cure as the SKI lattice dual.
                vt = M_inv_sqrt(self.y[None, :])
                gam = cg_solve(
                    mv_white, vt, tol=cg_tol, max_iters=cg_iters,
                    layout="bm", implicit_diff=False,
                )
                quad = jnp.sum(vt * gam)

                ld = logdet_M + slq_logdet(
                    mv_white, n, key=key, num_probes=num_probes,
                    lanczos_iters=lanczos_iters, dtype=self.y.dtype, layout="bm",
                )
            else:
                alpha = cg_solve(
                    mv, self.y, tol=cg_tol, max_iters=cg_iters, layout="bm",
                    implicit_diff=False,
                )
                quad = jnp.dot(self.y, alpha)
                ld = slq_logdet(
                    mv, n, key=key, num_probes=num_probes,
                    lanczos_iters=lanczos_iters, dtype=self.y.dtype, layout="bm",
                )
            return 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))

        # Compile-once + hoisted captures (x, y, basis — data-sized at uci2m;
        # a per-call @jax.jit retraced every invocation AND baked them into
        # the lowered module; same pattern as every sibling evaluator).
        mono_key = (r, int(num_probes), int(lanczos_iters), float(cg_tol),
                    int(cg_iters), self._cached_for)
        if getattr(self, "_iter_mono_key", None) != mono_key:
            from gp_grief_jax.utils.closure import explicit_closure

            self._iter_mono_key = None
            sds = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
                self.params,
            )
            key_sds = jax.ShapeDtypeStruct(key.shape, key.dtype)
            pure, consts = explicit_closure(_nlml, sds, key_sds)
            self._iter_mono = (jax.jit(pure), consts)
            self._iter_mono_key = mono_key
        fn, consts = self._iter_mono
        return -float(fn(consts, self.params, key))

    def log_likelihood_iterative_segmented(
        self,
        *,
        key=None,
        num_probes: int = 32,
        lanczos_iters: int = 64,
        cg_tol: float = 1e-8,
        cg_iters: int = 1000,
        precond_rank: int = 0,
        cg_segment_iters: int = 50,
        probe_chunk: int = 8,
        fuse_probes: bool = True,
        verbose: bool = False,
    ) -> float:
        """Segmented iterative NLML: the same estimator as
        :meth:`log_likelihood_iterative` (CG quadratic term + [whitened] SLQ
        log-det on the n×n operator — reference ``linalg.py`` CG + stochastic
        Lanczos, SURVEY.md §3.2), executed as a HOST loop of bounded device
        programs instead of one monolithic jitted evaluation.

        Why: the monolithic path traces every CG iteration and every SLQ
        probe into ONE long program at the 1.9M-point uci2m operating point.
        Here each program is one of: the basis/preconditioner prep (compile-once,
        cached on the model), a ``cg_segment_iters``-iteration CG segment
        (:func:`gp_grief_jax.ops.cg.cg_solve_segmented`), or a
        ``probe_chunk``-probe SLQ chunk
        (:func:`gp_grief_jax.ops.lanczos.slq_logdet_segmented`).  Operator
        operands (``Φ`` is 3 GB at uci2m) travel as device buffers, never as
        baked program constants (utils/closure.py rule).

        The CG quadratic term is the same recurrence as the monolithic path
        (identical up to stopping granularity); the SLQ chunks draw their
        probes from ``fold_in(key, chunk)``, so with ``precond_rank`` high
        enough that the whitened spectrum clusters at 1 the two paths agree
        to quadrature accuracy (~1e-6 at uci2m rank 300), and unwhitened they
        agree within Hutchinson sampling noise.

        ``fuse_probes`` (default True): run the SLQ probe chunks FIRST, each
        fused with ``lanczos_iters`` CG iterations through one
        ``(1+R, n)`` operator application per iteration
        (:func:`gp_grief_jax.ops.fused.fused_cg_slq_segment` — the O(n·p)
        GRIEF apply is two GEMMs whose cost is nearly flat in the batch
        rows, so the probe passes advance the CG solve for free); leftover
        CG segments then run to convergence.  Same probe draws and
        recurrence arithmetic as the separate passes.
        """
        from gp_grief_jax.kernels.grief import phi as _phi
        from gp_grief_jax.ops.cg import cg_solve_segmented
        from gp_grief_jax.ops.lanczos import slq_logdet_segmented
        from gp_grief_jax.ops.precond import (
            lowrank_spectral_factor,
            lowrank_sqrt_ops,
        )
        from gp_grief_jax.utils.closure import explicit_closure

        if key is None:
            key = jax.random.PRNGKey(0)
        self._ensure_cache()
        n = self.x.shape[0]
        r = int(min(precond_rank, self.n_eigs))

        # Compile-once prep, split into TWO cached programs: (a) the Φ build,
        # (b) the O(n·p²) CholeskyQR2 deflation factor taking Φ as an
        # ARGUMENT.  One fused program keeping both (n, p) Φ and (n, r) U as
        # outputs peaks at Φ-build intermediates + the QR chain's two Ut
        # buffers + both outputs ≈ 5 data-sized buffers — measured
        # RESOURCE_EXHAUSTED at uci2m (n=1.9M, p=400, r=300) on a 16 GB
        # device where either half alone fits; the same f32-robustness rules as
        # the monolithic path apply (see the comments there).
        if getattr(self, "_iter_prep_key", None) != (r, self._cached_for):
            # Invalidate BEFORE rebuilding: if the build throws mid-way (the
            # RESOURCE_EXHAUSTED scenario this method exists to avoid), a
            # retry must not see a half-stale cache (e.g. _iter_prep_factor
            # built for a different precond_rank).  The key is only set once
            # both programs exist.
            self._iter_prep_key = None
            self._iter_prep = None
            self._iter_prep_factor = None

            def _prep_phi(params):
                Phi = _phi(
                    self._basis, params["kernels"], self.xg, self.x,
                    dims=self.dims,
                )
                w = jnp.exp(params["log_w"])
                sigma2 = jnp.exp(params["log_noise"])
                return Phi, w, sigma2

            sds = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
                self.params,
            )
            pure, consts = explicit_closure(_prep_phi, sds)
            phi_sds = jax.eval_shape(pure, consts, sds)
            self._iter_prep = (jax.jit(pure), consts)
            if r > 0:

                def _prep_factor(Phi, w):
                    U, lam_r = lowrank_spectral_factor(
                        Phi, weights=w, top_r=r
                    )
                    return U, jnp.maximum(
                        lam_r, jnp.finfo(lam_r.dtype).tiny
                    )

                fpure, fconsts = explicit_closure(
                    _prep_factor, phi_sds[0], phi_sds[1]
                )
                self._iter_prep_factor = (jax.jit(fpure), fconsts)
            self._iter_prep_key = (r, self._cached_for)
        prep_fn, prep_consts = self._iter_prep
        Phi, w, sigma2 = prep_fn(prep_consts, self.params)
        if r > 0:
            fac_fn, fac_consts = self._iter_prep_factor
            U, lam_r = fac_fn(fac_consts, Phi, w)
        else:
            U = lam_r = None

        hi = jax.lax.Precision.HIGHEST

        def mv(vv):  # batch-major (B, n) rows — see the monolithic path
            t = jnp.matmul(vv, Phi, precision=hi)
            return jnp.matmul(t * w[None, :], Phi.T, precision=hi) + sigma2 * vv

        max_segments = max(1, -(-int(cg_iters) // int(cg_segment_iters)))
        if r > 0:
            M_inv, M_inv_sqrt, logdet_M = lowrank_sqrt_ops(
                U, lam_r, sigma2, layout="bm"
            )

            def op(vv):
                # Whitened-basis operator (NOT data-space PCG) — the thrice-
                # learned f32 rule; rationale in the monolithic path.
                return M_inv_sqrt(mv(M_inv_sqrt(vv)))

            rhs = M_inv_sqrt(self.y[None, :])
            ld_off = float(logdet_M)
        else:
            op = mv
            rhs = self.y[None, :]
            ld_off = 0.0

        # safe_batch_op: the fused path iterates the operator at
        # B = 1 + probe_chunk rows (9 by default), one of the padded
        # extents (ops/batching.py); the plain SLQ path's probe_chunk is
        # user-tunable too.  Padding to a multiple of 8 is exact and cheap
        # relative to the (B, n)×(n, p) GEMM apply.
        from gp_grief_jax.ops.batching import safe_batch_op

        op = safe_batch_op(op)

        if not fuse_probes:
            sol = cg_solve_segmented(
                op, rhs, tol=cg_tol, segment_iters=int(cg_segment_iters),
                max_segments=max_segments, layout="bm", verbose=verbose,
            )
            quad = float(jnp.sum(rhs * sol))
            ld = ld_off + slq_logdet_segmented(
                op, n, key=key, num_probes=num_probes,
                lanczos_iters=lanczos_iters, dtype=self.y.dtype,
                layout="bm", probe_chunk=probe_chunk,
            )
            return -0.5 * (quad + ld + n * float(np.log(2.0 * np.pi)))

        # Fused path: probe chunks first (each advances the CG solve through
        # shared operator applications), leftover CG segments after.  State
        # stays device-resident; one scalar/norm fetch per program.
        from gp_grief_jax.ops.cg import _make_pcg_step, _reducers
        from gp_grief_jax.ops.fused import fused_cg_slq_segment

        _colsum, _colnorm, _bc = _reducers("bm", None)
        x0 = jnp.zeros_like(rhs)
        rz0 = _colsum(rhs * rhs)
        state = (x0, rhs, rhs, rhs, rz0, jnp.zeros(rz0.shape, bool))
        bnorm = np.asarray(_colnorm(rhs))

        probe_chunk = max(1, min(int(probe_chunk), int(num_probes)))
        sizes = [probe_chunk] * (int(num_probes) // probe_chunk)
        if int(num_probes) % probe_chunk:
            sizes.append(int(num_probes) % probe_chunk)

        sds = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), t
        )
        key_sds = jax.ShapeDtypeStruct(key.shape, key.dtype)

        eff_tol = max(float(cg_tol), 20.0 * float(jnp.finfo(self.y.dtype).eps))
        stop = eff_tol * np.maximum(bnorm, float(jnp.finfo(self.y.dtype).tiny))
        # freeze_rz = stop²: converged CG columns freeze during the probe
        # phase (ops/fused.py — post-convergence f32 wander guard).
        freeze = jnp.asarray(stop * stop, self.y.dtype)

        def make_fused(rr):
            def f(st, k):
                Z = jax.random.rademacher(k, (rr, n), dtype=self.y.dtype)
                st2, ld_c = fused_cg_slq_segment(
                    op, st, Z, int(lanczos_iters), freeze_rz=freeze
                )
                return st2, _colnorm(st2[1]), st2[5], ld_c

            return f

        def seg_body(st):
            step = _make_pcg_step(op, lambda rr_: rr_, _colsum, _bc)
            st, _ = jax.lax.scan(
                lambda s, _: (step(*s), None), st, None,
                length=int(cg_segment_iters),
            )
            return st, _colnorm(st[1]), st[5]

        # Programs hoist the closure-captured Φ/U (multi-GB at uci2m) into
        # explicit arguments (utils/closure rule).
        fused_progs = {}
        for rr in sorted(set(sizes)):
            fp_, fc_ = explicit_closure(make_fused(rr), sds(state), key_sds)
            fused_progs[rr] = (jax.jit(fp_), fc_)
        sp_, sc_ = explicit_closure(seg_body, sds(state))
        seg_prog = (jax.jit(sp_), sc_)

        total = 0.0
        iters = 0
        rnorm_h = bnorm
        dead_h = np.zeros(rnorm_h.shape, bool)
        for c, rr in enumerate(sizes):
            fp_, fc_ = fused_progs[rr]
            state, rnorm, dead, ld_c = fp_(fc_, state, jax.random.fold_in(key, c))
            total += float(ld_c) * rr
            rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
            iters += int(lanczos_iters)
            if verbose:
                rel = float(np.max(rnorm_h / np.maximum(bnorm, 1e-30)))
                print(
                    f"[grief_nlml_segmented] fused chunk {c + 1}: iters={iters} "
                    f"max_rel_resid={rel:.3e}", flush=True,
                )
        leftover = max(0, int(cg_iters) - iters)
        for s in range(max(0, -(-leftover // int(cg_segment_iters)))):
            if not np.any((rnorm_h > stop) & ~dead_h):
                break
            sp2, sc2 = seg_prog
            state, rnorm, dead = sp2(sc2, state)
            rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
            iters += int(cg_segment_iters)
            if verbose:
                rel = float(np.max(rnorm_h / np.maximum(bnorm, 1e-30)))
                print(
                    f"[grief_nlml_segmented] segment {s + 1}: iters={iters} "
                    f"max_rel_resid={rel:.3e}", flush=True,
                )
        quad = float(jnp.sum(rhs * state[0]))
        ld = ld_off + total / int(num_probes)
        return -0.5 * (quad + ld + n * float(np.log(2.0 * np.pi)))

    # -- prediction ----------------------------------------------------------

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False):
        """O(n*·p) mean, O(n*·p²) variance via the weight-space posterior
        (reference §3.3: Nyström extension at test points)."""
        x_new = jnp.asarray(x_new, dtype=self.x.dtype)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        self._ensure_cache()

        if not hasattr(self, "_predict_jit"):

            def _predict(params, basis, stats, x_new):
                kerns = params["kernels"]
                Lp, theta = basis_posterior(
                    stats, params["log_w"], params["log_noise"]
                )
                Phis = phi(basis, kerns, self.xg, x_new, dims=self.dims)
                mean = Phis @ theta
                sigma2 = jnp.exp(params["log_noise"])
                A = jax.scipy.linalg.solve_triangular(Lp, Phis.T, lower=True)
                var = sigma2 * jnp.sum(A**2, axis=0)
                return mean, var, sigma2

            self._predict_jit = jax.jit(_predict)
        mean, var, sigma2 = self._predict_jit(self.params, self._basis, self._stats, x_new)
        if not compute_var:
            return np.asarray(mean)
        if include_noise:
            var = var + sigma2
        return np.asarray(mean), np.asarray(var)
