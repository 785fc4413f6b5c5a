"""Exact GP regression for data on a full Cartesian grid (Kronecker algebra).

The reference's grid-structured exact-GP capability (SURVEY.md §2 #1/#6–#8 and
BASELINE.json config 2: "3D product-grid GP: per-dim eigh + Kronecker matvec
CG solve"): when training inputs lie on a product grid, ``K = ⊗_d K_d`` and

    log|K + σ²I| = Σ_j log(λ⊗_j + σ²),     (λ⊗ = flattened ⊗_d λ_d)
    (K + σ²I)⁻¹ y = Q (Qᵀy / (λ⊗ + σ²))    (Q = ⊗_d Q_d via Kron matvecs)

so exact NLML on ``m = Π m_d`` points costs O(Σ m_d³) for the eigh plus
O(m·Σ m_d) per matvec — never O(m³).  A CG path (``solver="cg"``) exercises
the same structured matvec iteratively, which is what scales when a shift
structure (e.g. non-grid noise) breaks the eigen-shortcut.
"""

from __future__ import annotations

from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gp_grief_jax.kernels.base import inverse_positive
from gp_grief_jax.kernels.diag import cov_diag
from gp_grief_jax.kernels.grid import cov_grid, cross_cov_grid
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.models.base import BaseModel
from gp_grief_jax.ops.cg import cg_solve
from gp_grief_jax.ops.kron import kron_eigh, kron_matvec, kron_solve_schur
from gp_grief_jax.ops.kron_fast import kron_matvec_fast
from gp_grief_jax.ops.khatri_rao import kr_matvec

__all__ = ["GPKroneckerRegression"]


def _lam_kron(lams):
    lam = lams[0]
    for l in lams[1:]:
        lam = (lam[:, None] * l[None, :]).reshape(-1)
    return lam


def _clamp_psd(lams):
    """Clamp per-dim eigenvalues at their round-off floor.

    Kernel Gram factors are PSD, but finite-precision ``eigh`` returns small
    negatives (~eps·λmax; ≈1e-5 in f32 at m_d=128).  Left unclamped they get
    *amplified* by the other dimensions' λmax in the Kronecker product —
    λ_⊗ ≈ −eps·Πλmax can exceed σ², and ``log(λ_⊗+σ²)`` goes NaN.
    """
    out = []
    for lam in lams:
        eps = jnp.finfo(lam.dtype).eps
        floor = 10.0 * eps * jnp.max(lam)
        out.append(jnp.maximum(lam, floor))
    return tuple(out)


class GPKroneckerRegression(BaseModel):
    """Exact GP on a Cartesian grid: ``GPKroneckerRegression(xg, y, kern_list)``.

    ``xg``: per-dimension grid point arrays ``(m_d, s_d)`` (``s_d > 1`` =
    grouped input columns per grid dimension, the reference's ``sub_dim``);
    ``y``: responses on the full lattice, C-order flattened, shape
    ``(Π m_d,)``.  ``dims[d]`` names the input columns of test points that
    belong to grid dimension ``d`` (default: consecutive blocks of width
    ``s_d`` in grid order — the :class:`~gp_grief_jax.grid.InducingGrid`
    convention).
    """

    def __init__(
        self,
        xg: Sequence,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        *,
        noise_var: float = 1.0,
        dim_noise_var: float = 0.0,
        solver: str = "schur",
        cg_tol: float = 1e-10,
        cg_iters: int = 1000,
        precond_rank: int = 0,
        cg_precision: str = "exact",
        cg_whiten="auto",
        mesh=None,
        model_axis: str = "model",
        dims=None,
    ):
        self.xg = tuple(jnp.asarray(g) for g in xg)
        # Grouped dims (sub_dim > 1): predict's cross-covariances and prior
        # diagonal select each grid dimension's input-column block.  Default
        # mapping: consecutive blocks in grid order.
        sub = [1 if g.ndim == 1 else int(g.shape[1]) for g in self.xg]
        if dims is None:
            off = 0
            dims = []
            for s in sub:
                dims.append(tuple(range(off, off + s)))
                off += s
        else:
            dims = [tuple(int(c) for c in cols) for cols in dims]
            if len(dims) != len(self.xg) or any(
                len(cols) != s for cols, s in zip(dims, sub)
            ):
                raise ValueError(
                    f"dims must give one column list per grid dimension with "
                    f"widths {sub}; got {[len(c) for c in dims]}"
                )
            flat = [c for cols in dims for c in cols]
            n_cols = sum(sub)
            if len(set(flat)) != len(flat) or any(
                c < 0 or c >= n_cols for c in flat
            ):
                # Out-of-range indices would otherwise be silently CLAMPED
                # by the jitted gather in predict — wrong answers, no error.
                raise ValueError(
                    f"dims column indices must be distinct and in "
                    f"[0, {n_cols}); got {dims}"
                )
        self.dims = tuple(dims)
        self._n_cols = sum(sub)
        y = jnp.asarray(y).reshape(-1)
        m = int(np.prod([g.shape[0] for g in self.xg]))
        if y.shape[0] != m:
            raise ValueError(
                f"y must have one response per grid point: grid has {m} "
                f"points, y has {y.shape[0]}"
            )
        self.y = y
        self.m = m
        self.dim_noise_var = float(dim_noise_var)
        if solver not in ("schur", "cg"):
            raise ValueError("solver must be 'schur' or 'cg'")
        self.solver = solver
        self.cg_tol, self.cg_iters = cg_tol, cg_iters
        # CG option: deflate the top-`precond_rank` Kronecker eigenpairs
        # (ops/precond.py) — collapses iteration counts for fast-decay kernels.
        self.precond_rank = int(precond_rank)
        # "exact": every CG matvec at HIGHEST precision (f32-exact dots).
        # "mixed": iterative refinement (ops/cg.py:cg_solve_refined) — the CG
        # hot loop runs the DEFAULT-precision (TF32) matvec while
        # exact-precision residual refreshes keep the final solution at
        # `cg_tol` in exact arithmetic.
        # "mixed16": additionally stores the inner-CG state (r/p) in bf16 —
        # the state axpy traffic halves and the matvec reads a bf16 vector
        # (ops/cg.py:_cg_fixed state_dtype); same exact refreshes.
        if cg_precision not in ("exact", "mixed", "mixed16"):
            raise ValueError("cg_precision must be 'exact', 'mixed' or 'mixed16'")
        self.cg_precision = cg_precision
        # Whitened-basis CG (M^{-1/2} A M^{-1/2}) is REQUIRED when
        # σ² < ε_f32·λmax (data-space PCG's curvature is unresolvable and
        # the breakdown guard freezes it), but costs ~2
        # extra HIGHEST Kron matvecs per iteration (measured: the m=33.5M
        # mixed16 NLML regressed 2.2 → 14.6 s when whitened always-on).
        # "auto" decides STATICALLY from the construction noise: tiny noise
        # → whitened.  Pass True explicitly if training may drive σ² below
        # ~ε_f32·λmax of your grid Gram.
        if cg_whiten == "auto":
            cg_whiten = float(noise_var) < 1e-4
        self.cg_whiten = bool(cg_whiten)
        # Model parallelism (SURVEY §2 parallelism row 2): shard the
        # lattice's leading axis over `model_axis` of `mesh` — every CG
        # matvec in _loss runs through parallel.sharded.kron_matvec_sharded
        # (one psum_scatter per matvec).  The eigh, log-det, and
        # preconditioner algebra stay replicated (small factors); predict
        # and log_likelihood_segmented run the local matvec.
        self.mesh = mesh
        self.model_axis = str(model_axis)
        if mesh is not None:
            if solver != "cg":
                raise ValueError(
                    "mesh= (model-parallel matvec) requires solver='cg' — "
                    "the schur path has no large matvec to shard"
                )
            if model_axis not in mesh.shape:
                raise ValueError(
                    f"mesh has no axis {model_axis!r}: {dict(mesh.shape)}"
                )
            km = int(mesh.shape[model_axis])
            m1 = int(self.xg[0].shape[0])
            if m1 % km:
                raise ValueError(
                    f"leading grid dimension ({m1} points) must be divisible "
                    f"by the {model_axis!r} mesh axis size ({km} devices) — "
                    "pad the first grid dimension or reorder dimensions so "
                    "a divisible one is first"
                )
        kerns = (
            list(kern_list)
            if isinstance(kern_list, (list, tuple))
            else [kern_list] * len(self.xg)
        )
        # Working-dtype cast: f64 kernel leaves under enable_x64 + f32
        # grid/y promote solver intermediates and break scan carries — same
        # rule as the other model constructors.  Guard against non-float y
        # (integer responses must not truncate hyperparameters).
        wdt = (
            self.y.dtype
            if jnp.issubdtype(self.y.dtype, jnp.floating)
            else jnp.result_type(float)
        )
        kerns = jax.tree.map(lambda a: jnp.asarray(a, dtype=wdt), kerns)
        self.params = {
            "kernels": kerns,
            "log_noise": inverse_positive(noise_var).astype(wdt),
        }

    def _factors(self, kerns):
        return cov_grid(kerns, self.xg, dim_noise_var=self.dim_noise_var)

    def _loss(self, params):
        kerns, log_noise = params["kernels"], params["log_noise"]
        sigma2 = jnp.exp(log_noise)
        factors = self._factors(kerns)
        Qs, lams = kron_eigh(factors)
        lams = _clamp_psd(lams)
        lam = _lam_kron(lams)
        if self.solver == "schur":
            z = kron_matvec(tuple(Q.T for Q in Qs), self.y)
            quad = jnp.sum(z * z / (lam + sigma2))
        else:
            # cg_whiten: solve M⁻½AM⁻½ (required at tiny σ²); else the
            # historical data-space M⁻¹-PCG (2 fewer HIGHEST
            # Kron matvecs per iteration).  Closed-form whitener either way
            # (kron_deflation_sqrt_ops).
            M_inv = M_inv_sqrt = None
            if self.precond_rank > 0:
                from gp_grief_jax.ops.precond import kron_deflation_sqrt_ops
                from gp_grief_jax.ops.topk import top_p_kron_eigs

                _, idx = top_p_kron_eigs(lams, self.precond_rank)
                M_inv, M_inv_sqrt, _ = kron_deflation_sqrt_ops(
                    Qs, lams, idx, sigma2
                )
            whiten = self.cg_whiten and M_inv_sqrt is not None
            _w = M_inv_sqrt if whiten else (lambda v: v)
            M_inv_hook = None if whiten else M_inv

            if self.mesh is not None:
                from gp_grief_jax.parallel.sharded import kron_matvec_sharded

                def _kmv(u, precision=jax.lax.Precision.HIGHEST):
                    return kron_matvec_sharded(
                        factors, u, self.mesh, axis_name=self.model_axis,
                        precision=precision,
                    )
            else:

                def _kmv(u, precision=jax.lax.Precision.HIGHEST):
                    return kron_matvec_fast(factors, u, precision=precision)

            def mv_exact_w(v):
                u = _w(v)
                return _w(_kmv(u) + sigma2 * u)

            rhs_w = _w(self.y)
            # Deflation + refined-mixed DO NOT COMPOSE on this operator: the
            # low-precision matvec's absolute error (∝ λmax) dominates the
            # operator's action on the deflated subspace (measured |Ap_fast|
            # 5.8× off at m=33.5M/r=512) and the inner solves diverge, so
            # mixed precision is honored only unpreconditioned.
            use_mixed = (
                self.cg_precision in ("mixed", "mixed16")
                and self.precond_rank == 0
            )
            # Batch-major (1, m) state, like every solver path
            # (ops/cg.py:_reducers).
            def _bm(op):
                return lambda vv: op(vv[0])[None, :]

            if use_mixed:
                from gp_grief_jax.ops.cg import cg_solve_refined

                def mv_fast_w(v):
                    u = _w(v)
                    return _w(
                        _kmv(u, precision=jax.lax.Precision.DEFAULT)
                        + sigma2 * u
                    )

                alpha_w = cg_solve_refined(
                    _bm(mv_fast_w),
                    _bm(mv_exact_w),
                    rhs_w[None, :],
                    tol=max(self.cg_tol, 1e-7),
                    inner_iters=50,
                    max_restarts=max(1, self.cg_iters // 50),
                    M_inv=None if M_inv_hook is None else _bm(M_inv_hook),
                    state_dtype=(
                        jnp.bfloat16 if self.cg_precision == "mixed16" else None
                    ),
                    layout="bm",
                )[0]
            else:
                alpha_w = cg_solve(
                    _bm(mv_exact_w),
                    rhs_w[None, :],
                    tol=self.cg_tol,
                    max_iters=self.cg_iters,
                    M_inv=None if M_inv_hook is None else _bm(M_inv_hook),
                    layout="bm",
                )[0]
            # quad = yᵀA⁻¹y = (M⁻½y)ᵀ (M⁻½AM⁻½)⁻¹ (M⁻½y) = rhs_w·alpha_w.
            quad = jnp.dot(rhs_w, alpha_w)
        logdet = jnp.sum(jnp.log(lam + sigma2))
        return 0.5 * (quad + logdet + self.m * jnp.log(2.0 * jnp.pi))

    def log_likelihood_segmented(
        self, *, cg_segment_iters: int = 60, verbose: bool = False
    ) -> float:
        """Value-only log marginal likelihood with the CG quadratic term
        host-segmented (same host loop as
        :func:`gp_grief_jax.ops.cg.cg_solve_segmented`).

        For ``solver="cg"`` at lattice sizes where one CG program would run
        long.  The log-det stays the closed Kronecker-eigenvalue form
        (one small program); only the solve is segmented, with the
        eigendecomposition and preconditioner built once and shared across
        segments as device arrays.

        Compile-once: the (init, segment, quad) programs are built and
        jitted ONCE per ``(cg_segment_iters, precond_rank, cg_whiten)`` and
        cached on the model (the GPSKIRegression pattern) — repeated NLML
        evaluations cost device time + one dispatch per segment.  Solver
        state runs batch-major ``(1, m)`` (``layout="bm"``, see
        :func:`gp_grief_jax.ops.cg._reducers`).
        """
        progs = self._nlml_programs(int(cg_segment_iters))
        (init_fn, init_c), (seg_fn, seg_c), (fin_fn, fin_c) = progs
        aux, rhs, state, bnorm, rnorm = init_fn(init_c, self.params)
        eff_tol = max(
            float(self.cg_tol), 20.0 * float(jnp.finfo(self.y.dtype).eps)
        )
        stop = eff_tol * np.maximum(
            np.asarray(bnorm), float(jnp.finfo(self.y.dtype).tiny)
        )
        rnorm_h = np.asarray(rnorm)
        dead_h = np.zeros(rnorm_h.shape, bool)
        max_segments = max(1, -(-self.cg_iters // cg_segment_iters))
        iters = 0
        for s in range(max_segments):
            if not np.any((rnorm_h > stop) & ~dead_h):
                break
            state, rnorm, dead = seg_fn(seg_c, aux, state)
            # The per-segment fetch is the host-side convergence test; it
            # also bounds the async queue at one segment.
            rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
            iters += int(cg_segment_iters)
            if verbose:
                rel = float(np.max(rnorm_h / np.maximum(np.asarray(bnorm), 1e-30)))
                print(
                    f"[nlml_segmented] segment {s + 1}: iters={iters} "
                    f"max_rel_resid={rel:.3e}"
                )
        quad, logdet = (float(v) for v in fin_fn(fin_c, aux, rhs, state))
        return -0.5 * (quad + logdet + self.m * float(np.log(2.0 * np.pi)))

    def _nlml_programs(self, cg_segment_iters: int):
        """Cached compile-once programs for :meth:`log_likelihood_segmented`."""
        key = (int(cg_segment_iters), self.precond_rank, self.cg_whiten)
        if getattr(self, "_nlml_progs_key", None) != key:
            self._nlml_progs_key = key
            self._nlml_progs = self._build_nlml_programs(int(cg_segment_iters))
        return self._nlml_progs

    def _build_nlml_programs(self, segment_iters: int):
        """Compile-once (init, segment, quad) programs for
        :meth:`log_likelihood_segmented`.  Hyperparameters and the
        evaluation's eigendecomposition/preconditioner travel through an
        ``aux`` pytree of explicit program arguments; closure-captured
        arrays (``y``) are hoisted by
        :func:`gp_grief_jax.utils.closure.explicit_closure` (never embedded
        as data-sized program constants)."""
        from gp_grief_jax.ops.cg import _make_pcg_step, _reducers
        from gp_grief_jax.utils.closure import explicit_closure

        _colsum, _colnorm, _bc = _reducers("bm", None)

        def build_ops(aux):
            """(matvec, inner preconditioner, whitener) on (1, m) rows.

            All Kron/deflation algebra runs on the flat ``(m,)`` vector
            (good lane occupancy); only the CG state is (1, m)."""
            factors, sigma2, Qs, lams, _ = aux
            _w = lambda v: v  # noqa: E731
            M_inv_hook = None
            if self.precond_rank > 0:
                from gp_grief_jax.ops.precond import kron_deflation_sqrt_ops
                from gp_grief_jax.ops.topk import top_p_kron_eigs

                _, idx = top_p_kron_eigs(lams, self.precond_rank)
                M_inv, M_inv_sqrt, _ = kron_deflation_sqrt_ops(
                    Qs, lams, idx, sigma2
                )
                if self.cg_whiten:
                    _w = M_inv_sqrt
                else:
                    M_inv_hook = M_inv

            def mv(v_bm):
                u = _w(v_bm[0])
                return _w(kron_matvec_fast(factors, u) + sigma2 * u)[None]

            precond = (
                (lambda r_bm: M_inv_hook(r_bm[0])[None])
                if M_inv_hook is not None
                else (lambda r_bm: r_bm)
            )
            return mv, precond, _w

        def init_fn(params):
            sigma2 = jnp.exp(params["log_noise"])
            factors = self._factors(params["kernels"])
            Qs, lams = kron_eigh(factors)
            lams = _clamp_psd(lams)
            logdet = jnp.sum(jnp.log(_lam_kron(lams) + sigma2))
            aux = (factors, sigma2, Qs, lams, logdet)
            _, precond, _w = build_ops(aux)
            rhs = _w(self.y)[None, :]
            # x0 = 0 → r0 = rhs exactly (linearity): the init matvec is
            # skipped; z0 goes through the inner preconditioner when the
            # data-space M⁻¹-PCG branch is active.
            x0 = jnp.zeros_like(rhs)
            z0 = precond(rhs)
            rz0 = _colsum(rhs * z0)
            state = (x0, rhs, z0, z0, rz0, jnp.zeros(rz0.shape, bool))
            return aux, rhs, state, _colnorm(rhs), _colnorm(rhs)

        def seg_fn(aux, state):
            mv, precond, _ = build_ops(aux)
            step = _make_pcg_step(mv, precond, _colsum, _bc)

            def body(s, _):
                return step(*s), None

            state, _ = lax.scan(body, state, None, length=segment_iters)
            return state, _colnorm(state[1]), state[5]

        def fin_fn(aux, rhs, state):
            # quad = yᵀA⁻¹y = (M⁻½y)ᵀ(M⁻½AM⁻½)⁻¹(M⁻½y) — both branches
            # reduce to rhs·x (rhs = y when unwhitened).
            logdet = aux[4]
            return jnp.dot(rhs[0], state[0][0]), logdet

        sds = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), t
        )
        ip, ic = explicit_closure(init_fn, sds(self.params))
        out_sds = jax.eval_shape(ip, ic, sds(self.params))
        aux_sds, rhs_sds, state_sds = out_sds[0], out_sds[1], out_sds[2]
        sp, sc = explicit_closure(seg_fn, aux_sds, state_sds)
        fp, fc = explicit_closure(fin_fn, aux_sds, rhs_sds, state_sds)
        return (jax.jit(ip), ic), (jax.jit(sp), sc), (jax.jit(fp), fc)

    def predict(
        self,
        x_new,
        compute_var: bool = True,
        include_noise: bool = False,
        chunk: int = 0,
    ):
        """Scattered-point prediction off the grid: Khatri-Rao cross-covs.

        mean = K_*U α (one ``kr_matvec``); var via structured solves against
        the ``(m, c)`` cross-covariance columns of one test *chunk* at a time
        — the variance path materializes only ``m × chunk``, never ``m × n*``
        (a 128³ grid × 10k test points would be 8.6 TB dense; chunked it is
        ``m·c`` ≈ 0.5 GB at the auto chunk).  Chunks run as a HOST loop over
        one compiled per-chunk program so a single device execution stays
        bounded regardless of ``n*``.
        ``chunk=0`` auto-sizes from ``m``; pass an explicit value to override.
        """
        x_new = jnp.asarray(x_new)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        if int(x_new.shape[1]) != self._n_cols:
            raise ValueError(
                f"test points must have {self._n_cols} columns (the grid's "
                f"total sub_dim width); got {int(x_new.shape[1])}"
            )
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = np.zeros((0,), dtype=np.asarray(self.y).dtype)
            return empty if not compute_var else (empty, empty.copy())
        if chunk <= 0:
            # ~512 MB f32 of (m, c) columns, at least 16, at most n*.
            chunk = int(max(1, min(n_star, max(16, (1 << 27) // max(self.m, 1)))))
        chunk = min(chunk, n_star)
        n_pad = -(-n_star // chunk) * chunk
        if n_pad != n_star:
            x_pad = jnp.concatenate(
                [x_new, jnp.broadcast_to(x_new[:1], (n_pad - n_star, x_new.shape[1]))]
            )
        else:
            x_pad = x_new
        cache_key = (chunk, bool(compute_var))
        if getattr(self, "_predict_key", None) != cache_key:
            self._predict_key = cache_key

            def _prep(params):
                kerns, log_noise = params["kernels"], params["log_noise"]
                sigma2 = jnp.exp(log_noise)
                factors = self._factors(kerns)
                Qs, lams = kron_eigh(factors)
                lams = _clamp_psd(lams)
                alpha = kron_solve_schur(Qs, lams, self.y, sigma2)
                return Qs, lams, alpha, sigma2

            def _chunk_prog(params, Qs, lams, alpha, xc):
                kerns = params["kernels"]
                sigma2 = jnp.exp(params["log_noise"])
                Kx = cross_cov_grid(kerns, xc, self.xg, dims=self.dims)  # (c, m_d) per dim
                mean = kr_matvec(list(Kx), alpha)
                if not compute_var:
                    return mean, jnp.zeros_like(mean)
                prior_diag = cov_diag(kerns, xc, dims=self.dims)
                # Batch-major: keep the test chunk LEADING and fold it into the Kronecker structure as
                # an identity factor — I_c ⊗ (⊗K_d) has eigensystem
                # (I_c ⊗ Q, 1_c ⊗ λ), so the Schur solve runs unchanged on
                # the (c·m,) flat vector.
                c = int(xc.shape[0])
                KUx_bm = _kr_rows_dense(Kx)  # (c, m): row i = ⊗_d Kx_d[i, :]
                S_bm = kron_solve_schur(
                    (jnp.eye(c, dtype=KUx_bm.dtype), *Qs),
                    (jnp.ones((c,), dtype=KUx_bm.dtype), *lams),
                    KUx_bm.reshape(-1),
                    sigma2,
                ).reshape(c, -1)
                var = prior_diag - jnp.sum(KUx_bm * S_bm, axis=1)
                return mean, jnp.maximum(var, 0.0)

            # Hoist _prep's captured arrays (y is 134 MB at a 33.5M lattice;
            # utils/closure.py).
            from gp_grief_jax.utils.closure import explicit_closure

            sds = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
                self.params,
            )
            prep_pure, prep_consts = explicit_closure(_prep, sds)
            self._prep_jit = (jax.jit(prep_pure), prep_consts)
            self._chunk_jit = jax.jit(_chunk_prog)
        prep_fn, prep_consts = self._prep_jit
        Qs, lams, alpha, sigma2 = prep_fn(prep_consts, self.params)
        means, vars_ = [], []
        for i in range(0, n_pad, chunk):
            mc, vc = self._chunk_jit(self.params, Qs, lams, alpha, x_pad[i : i + chunk])
            # Per-chunk fetch: keeps the async queue bounded.
            means.append(np.asarray(mc))
            vars_.append(np.asarray(vc))
        mean = jnp.asarray(np.concatenate(means)[:n_star])
        var = jnp.asarray(np.concatenate(vars_)[:n_star])
        if not compute_var:
            return np.asarray(mean)
        if include_noise:
            var = var + sigma2
        return np.asarray(mean), np.asarray(var)


def _kr_rows_dense(A_list):
    """Dense ``(n, Π m_d)`` matrix whose row ``i`` is ``⊗_d A_d[i, :]``."""
    out = A_list[0]  # (n, m_1)
    for A in A_list[1:]:
        n = out.shape[0]
        out = (out[:, :, None] * A[:, None, :]).reshape(n, -1)
    return out
