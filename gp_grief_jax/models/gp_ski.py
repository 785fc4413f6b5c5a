"""SKI / KISS-GP regression: scattered data tied to a grid by interpolation.

BASELINE config 2 ("SKI-style interpolation weights"): the kernel is
approximated as ``k̂(x, z) = W_x (⊗_d K_d) W_zᵀ`` with sparse linear
interpolation weights ``W`` (ops/interp.py), so every matvec with
``K̂ + σ²I`` is gather → Kron matvec → scatter, ``O(n·2^d + m·Σm_d)``.
NLML uses CG for the quadratic term and SLQ for the log-det, with BBMM-style
stop-gradient surrogates for unbiased hyperparameter gradients (same pattern
as ``gp_regression.gp_nlml_iterative``).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gp_grief_jax.grid import InducingGrid
from gp_grief_jax.kernels.base import inverse_positive
from gp_grief_jax.kernels.grid import cov_grid
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.models.base import BaseModel, check_xy
from gp_grief_jax.ops.batching import safe_batch_op
from gp_grief_jax.ops.cg import cg_solve
from gp_grief_jax.ops.interp import (
    build_corner_stream,
    build_interp_plan,
    interp_matvec,
    interp_matvec_bm,
    interp_matvec_bm_fast,
    interp_rmatvec,
    interp_rmatvec_bm,
    interp_rmatvec_bm_exact,
    interp_rmatvec_bm_fast,
    interp_weights,
)
from gp_grief_jax.ops.interp_stencil import build_wtw_stencil, make_wtw_stencil_op
from gp_grief_jax.ops.interp_windowed import build_windowed_plan, make_windowed_ops
from gp_grief_jax.ops.kron import kron_eigh
from gp_grief_jax.ops.kron_fast import kron_matvec_fast
from gp_grief_jax.ops.lanczos import slq_logdet
from gp_grief_jax.ops.precond import lowrank_spectral_factor, lowrank_sqrt_ops
from gp_grief_jax.ops.topk import top_p_kron_eigs

__all__ = ["GPSKIRegression", "lattice_cbar", "warn_lattice_small_n"]


def warn_lattice_small_n(n: int, xg) -> None:
    """Warn when ``solver='lattice'`` is requested at n << m — shared by the
    single-chip and sharded SKI constructors (capability parity, SURVEY §2
    parallelism row 1)."""
    m_total = int(np.prod([int(g.shape[0]) for g in xg]))
    if n < m_total // 4:
        import warnings

        warnings.warn(
            "solver='lattice' at n << m: the dual log-det assembles "
            "O(M·log σ²)-scale terms whose SLQ quadrature bias can "
            "dominate the NLML (measured: 100k points on a 1M lattice "
            "was off by ~1e5 at lanczos_iters=30 while solver='data' "
            "converges fine there).  Prefer solver='data' when "
            "n < m/4; the dual is for n ≳ m where the data-space "
            "operator exceeds f32 CG conditioning.",
            stacklevel=3,
        )


_WINDOWED_MIN_FILL = 1.5
"""Points per lattice cell (``n / M``) from which the windowed applies serve
``W``/``Wᵀ``; below it the flat ELL plan does.  One ``W`` plus one ``Wᵀ`` at
B=9 on a 32⁴ lattice, on an NVIDIA H100 (400 W): ELL 0.84 / 4.22 / 9.29 ms
against windowed 1.90 / 5.02 / 8.97 ms at n/M = 0.095 / 0.95 / 1.9."""


def lattice_cbar(iw, stream=None) -> float:
    """Mean of ``diag(WᵀW)`` for an :class:`~gp_grief_jax.ops.interp.
    InterpWeights` — host numpy, θ-independent (shared by the single-device
    and sharded lattice-dual solvers).  ``diag(WᵀW)[c] = Σ w²`` over the
    corner-update stream entries landing on cell ``c``, so the mean is just
    ``Σ w² / M`` — one reduction over the shared :class:`~gp_grief_jax.ops.
    interp.CornerStream` when one is passed (zero-weight entries pruned
    there contribute 0)."""
    import math as _math

    M = _math.prod(iw.shape)
    st = stream if stream is not None else build_corner_stream(iw)
    return float(np.sum(st.w_u.astype(np.float64) ** 2) / M)


class GPSKIRegression(BaseModel):
    """``GPSKIRegression(x, y, kern_list, grid, noise_var, ...)``.

    ``grid`` may be an :class:`InducingGrid` or per-dim point arrays.

    ``precond_rank`` (default 256, capped at the lattice size): rank-r
    Kronecker-eigen deflation preconditioner for every CG solve, plus
    whitened SLQ for the log-det (:meth:`_build_precond`).  ON BY DEFAULT
    because smooth-kernel SKI operators are routinely κ ≳ 1/ε_f32, where
    unpreconditioned f32 CG does not converge at all — at the n=100k /
    m=32⁴ benchmark shape it turns a non-converging solve (relative
    quadratic-form error ~10⁶ after 300 iterations) into 69-iteration
    convergence to 1e-6.  Set 0 to disable.
    """

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid=None,
        *,
        noise_var: float = 1.0,
        dim_noise_var: float = 0.0,
        mbar: int = 30,
        num_probes: int = 16,
        lanczos_iters: int = 40,
        cg_tol: float = 1e-8,
        cg_iters: int = 500,
        cg_precision: str = "exact",
        precond_rank: int = 256,
        solver: str = "data",
        wtw_stencil: bool = True,
        train_mixed16: bool = False,
        key=None,
    ):
        x, y = check_xy(x, y)
        if grid is None:
            grid = InducingGrid.build(np.asarray(x), mbar=mbar)
        xg = grid.xg if isinstance(grid, InducingGrid) else grid
        self.xg = tuple(jnp.asarray(g, dtype=x.dtype) for g in xg)
        if any(g.ndim == 2 and g.shape[1] > 1 for g in self.xg):
            raise NotImplementedError(
                "multi-column (sub_dim > 1) grid dimensions are not supported by "
                "linear grid interpolation — use GPGriefModel with grouped dims"
            )
        self.x, self.y = x, y
        self.iw = interp_weights(x, self.xg)
        # Interpolation plans are built LAZILY on first use (__getattr__
        # below): the host-numpy builders take seconds each at n=1M, and
        # which a workflow touches depends on the regime — the flat ELL plan
        # at n ≪ m (and on predict paths), windowed applies at n ≳ m.
        self.dim_noise_var = float(dim_noise_var)
        # "mixed": NLML/predict solves run iterative refinement — the CG hot
        # loop uses the DEFAULT-precision (TF32) Kron matvec, exact residual
        # refreshes set the final accuracy (ops/cg.py:cg_solve_refined).
        if cg_precision not in ("exact", "mixed"):
            raise ValueError("cg_precision must be 'exact' or 'mixed'")
        # "data": CG on the n×n data-space operator K̂+σ²I (rank-r deflation
        # preconditioned).  "lattice": the Woodbury/determinant-lemma dual on
        # the M×M lattice operator B = σ²K⁻¹ + WᵀW, whitened in closed form —
        # REQUIRED at n ≳ m where the data-space operator exceeds f32 CG's
        # conditioning range entirely (see _lattice_spectra).
        if solver not in ("data", "lattice"):
            raise ValueError("solver must be 'data' or 'lattice'")
        self.solver = solver
        # WᵀW-as-stencil fusion for the lattice dual's hot loop (built
        # lazily; ops/interp_stencil.py).  The builder self-gates on table
        # memory (3^d · M · 4 bytes).
        self._use_wtw_stencil = bool(wtw_stencil)
        # bf16 state + bf16 matvec inputs for the TRAINING step solves only
        # (optimize_segmented; lattice dual).  The whitened dual's CG
        # stagnates at ~3.6e-3 relative there — far below the Hutchinson
        # probe noise the gradient already carries.  Reported NLML
        # (log_likelihood*) and prediction always solve in f32.
        self._train_mixed16 = bool(train_mixed16)
        if solver == "lattice":
            warn_lattice_small_n(int(x.shape[0]), self.xg)
        self._opts = dict(
            num_probes=num_probes, lanczos_iters=lanczos_iters,
            cg_tol=cg_tol, cg_iters=cg_iters, cg_precision=cg_precision,
            precond_rank=int(precond_rank),
        )
        self._key = jax.random.PRNGKey(0) if key is None else key
        kerns = (
            list(kern_list)
            if isinstance(kern_list, (list, tuple))
            else [kern_list] * len(self.xg)
        )
        # Keep every kernel leaf in the working dtype: under enable_x64,
        # make_kernel's leaves default to f64 — mixed with f32 data they
        # promote solver intermediates to f64 and break scan carries
        # (measured: lanczos carry dtype mismatch).  Guard
        # against non-float inputs (ints must not truncate hyperparameters).
        wdt = (
            x.dtype
            if jnp.issubdtype(x.dtype, jnp.floating)
            else jnp.result_type(float)
        )
        kerns = jax.tree.map(lambda a: jnp.asarray(a, dtype=wdt), kerns)
        self.params = {"kernels": kerns, "log_noise": inverse_positive(noise_var).astype(wdt)}

    _LAZY_PLANS = (
        "_cstream",
        "_plan",
        "_wplan",
        "_w_ops",
        "_wtw_stencil",
        "_wtw_op",
    )

    def __getattr__(self, name):
        # Lazy interpolation plans (see __init__) — fires only while the
        # attribute is unset; tests may still assign these directly.  The
        # first touch can happen inside a jit trace (a solver tracing
        # _matvec_bm): without ensure_compile_time_eval the builders'
        # jnp.asarray conversions would produce tracers that get cached on
        # self and leak into every later program.
        if name in GPSKIRegression._LAZY_PLANS:
            import jax

            with jax.ensure_compile_time_eval():
                return self._build_lazy_plan(name)
        raise AttributeError(
            f"{type(self).__name__!s} object has no attribute {name!r}"
        )

    def _build_lazy_plan(self, name):
        if name == "_cstream":
            # Shared corner-update stream: the one 1M-point sort + per-cell
            # rank counting every plan builder starts from (CornerStream in
            # ops/interp.py).  Built once, threaded through all builders —
            # the per-plan host cost collapses to counting-sort fills.
            self._cstream = build_corner_stream(self.iw)
            return self._cstream
        if name == "_plan":
            # Scatter-free flat ELL plan: the naive Wᵀ is 2^d colliding
            # scatter-adds; the ELL slot-gather form is EXACT (same short
            # f32 sums, reordered) and deterministic.
            self._plan = build_interp_plan(self.iw, stream=self._cstream)
            return self._plan
        if name == "_wplan":
            # Windowed applies for the n ≳ m regime: gather sources become
            # contiguous dynamic_slice windows over cell-sorted points
            # (ops/interp_windowed.py).  None below _WINDOWED_MIN_FILL or
            # when the windows would be unbounded (clustered data).
            M = math.prod(self.iw.shape)
            self._wplan = (
                build_windowed_plan(self.iw, stream=self._cstream)
                if int(self.x.shape[0]) >= _WINDOWED_MIN_FILL * M
                else None
            )
            return self._wplan
        if name == "_w_ops":
            self._w_ops = (
                make_windowed_ops(self._wplan)
                if self._wplan is not None
                else None
            )
            return self._w_ops
        if name == "_wtw_stencil":
            # WᵀW collapsed to ≤3^d shifted multiply-adds on the lattice —
            # removes BOTH gather-bound point↔lattice maps from the lattice
            # dual's hot loop (ops/interp_stencil.py).  Geometry-only: never
            # rebuilds during training.
            self._wtw_stencil = (
                build_wtw_stencil(self.iw, stream=self._cstream)
                if self._use_wtw_stencil
                else None
            )
            return self._wtw_stencil
        if name == "_wtw_op":
            self._wtw_op = (
                make_wtw_stencil_op(self._wtw_stencil)
                if self._wtw_stencil is not None
                else None
            )
            return self._wtw_op
        raise AssertionError(name)  # pragma: no cover - _LAZY_PLANS gate

    # -- structured operator ---------------------------------------------------

    def _rmatvec_bm(self, u_bm, fast: bool = False):
        """Batch-major ``Wᵀ u`` dispatch (data-order input): the windowed
        applies where the plan exists (n ≳ m, ops/interp_windowed.py), else
        the ELL slot-gather (exact) or, with ``fast=True``, the cumsum
        stream form (~5e-5 rel — refined-CG inner loops only)."""
        if self._w_ops is not None:
            return self._w_ops[1](u_bm[:, self._wplan.perm])
        if fast:
            return interp_rmatvec_bm_fast(self._plan, u_bm)
        return interp_rmatvec_bm_exact(self._plan, u_bm)

    def _w_bm(self, v_lat_bm):
        """Batch-major forward ``W v`` (data-order output), windowed when
        the plan exists."""
        if self._w_ops is not None:
            return self._w_ops[0](v_lat_bm)[:, self._wplan.inv_perm]
        return interp_matvec_bm_fast(self._plan, v_lat_bm)

    def _matvec_bm(self, factors, sigma2, precision=None, fast: bool = False):
        """Batch-major ``(K̂ + σ²I)``: ``v (B, n) → (B, n)``.

        The solver-facing form: CG/SLQ state and every lattice intermediate
        keep the long axis contiguous, so the batch is folded into the
        Kronecker structure as a leading identity factor (``I_B ⊗ (⊗K_d)`` on the ``(B·M,)`` flat vector; the
        grouped-cyclic chain absorbs ``I_B`` into its first group at no
        extra pass).

        Interpolation always runs scatter-free off precomputed plans — see
        :meth:`_rmatvec_bm` for the ``Wᵀ`` dispatch (windowed → ELL
        slot-gather → cumsum).  The forward ``W`` is one fused exact
        gather in every mode."""
        kw = {} if precision is None else {"precision": precision}

        def mv(v):  # (B, n)
            B = int(v.shape[0])
            u = self._rmatvec_bm(v, fast=fast)  # (B, M)
            eyeB = jnp.eye(B, dtype=v.dtype)
            u = kron_matvec_fast((eyeB, *factors), u.reshape(-1), **kw)
            u = u.reshape(B, -1)
            return self._w_bm(u) + sigma2 * v

        return mv

    def _matvec(self, factors, sigma2, precision=None):
        """Column-layout public form (``(n,)`` / ``(n, B)``), delegating to
        the batch-major core."""
        mv_bm = self._matvec_bm(factors, sigma2, precision)

        def mv(v):
            if v.ndim == 1:
                return mv_bm(v[None, :])[0]
            return mv_bm(v.T).T

        return mv

    def _build_precond(self, factors, sigma2):
        """Rank-r deflation of ``A = W K Wᵀ + σ²I`` from the top-r Kronecker
        eigenpairs of the lattice Gram, projected to the data points.

        The unpreconditioned operator at the BASELINE config-2 shape
        (n=100k, RBF ls=0.8 on 32⁴, σ²=0.1) has κ ≳ 1/ε_f32: 300 CG
        iterations leave a quadratic-form estimate off by ~10⁶ and the
        "converged" NLML moves by that much under any rounding change — the
        answer is garbage, not just slow.  With
        ``K = (⊗Q_d) Λ (⊗Q_d)ᵀ``, the top-r eigenpairs give
        ``A ≈ B₀B₀ᵀ + σ²I`` with ``B₀ = W Q_r Λ_r^{1/2}`` — a Khatri-Rao
        column gather: ``B₀[:, j] = λ_j^{1/2} Π_d (W_d Q_d)[:, idx_jd]``,
        built from d skinny ``(n, m_d)`` per-dim projections.  An r×r eigh
        of ``B₀ᵀB₀`` orthonormalizes it (:func:`lowrank_sqrt_ops_from_factor`), whose
        ``M^{-1/2}`` also whitens SLQ (log|A| = log|M| + log|M⁻½AM⁻½|).

        Returns ``(M_inv, M_inv_sqrt, logdet_M)`` or ``None`` (rank 0).
        """
        r = self._precond_rank()
        if r <= 0:
            return None
        U, lam = self._precond_spectral(factors, r)
        return lowrank_sqrt_ops(U, lam, sigma2, layout="bm")

    def _precond_rank(self) -> int:
        """Effective deflation rank: ``precond_rank`` capped at lattice/data size."""
        r = self._opts["precond_rank"]
        if r <= 0:
            return 0
        m_total = int(np.prod([int(g.shape[0]) for g in self.xg]))
        return min(r, m_total, int(self.x.shape[0]))

    def _precond_spectral(self, factors, r):
        """Concrete spectral arrays ``(U (n,r) orthonormal, lam (r,))`` of the
        deflation basis — separated from :meth:`_build_precond` so a
        host-segmented NLML can compute them ONCE in one jitted program and
        share them (as device arrays) across segment programs
        (:meth:`log_likelihood_segmented`)."""
        # The whole build runs under HIGHEST matmul precision: eigh /
        # cholesky / triangular_solve are blocked algorithms whose inner
        # dots follow the *default* matmul precision (TF32 on the GPU) — a
        # ~1e-3 basis is not SPD-consistent and preconditioned CG diverges.
        with jax.default_matmul_precision("highest"):
            Qs, lams = kron_eigh(factors)
            log_lam, idx = top_p_kron_eigs(lams, r)
            lam_r = jnp.exp(log_lam)  # (r,) descending
            U0 = None
            for d_, Qd in enumerate(Qs):
                m_d = Qd.shape[0]
                i0 = self.iw.idx[d_]
                i1 = jnp.minimum(i0 + 1, m_d - 1)
                w2 = self.iw.w[d_]
                Pd = w2[:, 0:1] * Qd[i0, :] + w2[:, 1:2] * Qd[i1, :]  # W_d Q_d
                col = Pd[:, idx[:, d_]]  # (n, r)
                U0 = col if U0 is None else U0 * col
            # f32-robust spectral form: orthonormalize U0 BEFORE touching Λ
            # (CholeskyQR2 + r×r congruence eigh) — a one-shot eigh of the
            # λ-scaled Gram diverges CG; see lowrank_spectral_factor for
            # the measured failure mode.
            return lowrank_spectral_factor(U0, weights=lam_r)

    # -- lattice-dual (Woodbury) solver ------------------------------------------

    def _lattice_cbar(self) -> float:
        """Mean of ``diag(WᵀW)`` (per-lattice-node interpolation mass²) —
        the scalar shift of the closed-form whitener.  θ-independent; host
        numpy, computed once."""
        if not hasattr(self, "_cbar"):
            self._cbar = lattice_cbar(self.iw, stream=self._cstream)
        return self._cbar

    def _lattice_spectra(self, factors, sigma2):
        """Closed-form pieces of the lattice dual (jit-traceable).

        Why this path exists: the data-space operator ``Â = WKWᵀ + σ²I`` at
        n ≳ m has κ beyond 1/ε_f32 — at the n=1M / 32⁴ config, CG *diverges
        within 50 iterations at every deflation rank tried* (0/128/256/512),
        with operator and preconditioner
        both verified healthy.  The dual works on the M×M lattice operator
        ``B = σ²K⁻¹ + WᵀW`` (matrix inversion + determinant lemmas):

            yᵀÂ⁻¹y = (yᵀy − (Wᵀy)ᵀ B⁻¹ (Wᵀy)) / σ²
            log|Â|  = (n−M)·log σ² + Σ_j log(σ² + c̄λ_j) + log|W̃|

        with the whitener ``M = σ²K⁻¹ + c̄I`` EXACT in the Kronecker
        eigenbasis (``M^{−1/2} = Q diag(√(λ/(σ²+c̄λ))) Qᵀ`` — bounded, no
        1/λ anywhere) and ``W̃ = M^{−1/2} B M^{−1/2} = I + M^{−1/2}(WᵀW −
        c̄I)M^{−1/2}`` — **K⁻¹ never applied**.  W̃'s spectrum clusters
        around local-density/c̄ ratios, so whitened CG/SLQ converge in tens
        of iterations where the primal diverges.  ``Σ log λ + Σ log(σ²/λ +
        c̄) = Σ log(σ² + c̄λ)`` keeps the log-det assembly insensitive to
        the PSD eigenvalue clamp.

        Returns ``(Qs, wjs, ld_MK)``: per-dim eigenvectors, the (M,)
        ``M^{-1/2}`` eigen-scales, and ``Σ log(σ² + c̄λ)``.
        """
        from gp_grief_jax.models.gp_kron import _clamp_psd, _lam_kron

        cbar = self._lattice_cbar()
        Qs, lams = kron_eigh(factors)
        lams = _clamp_psd(lams)
        lam = _lam_kron(lams)  # (M,)
        wjs = jnp.sqrt(lam / (sigma2 + cbar * lam))
        ld_MK = jnp.sum(jnp.log(sigma2 + cbar * lam))
        return Qs, wjs, ld_MK

    def _wtw_bm_op(self):
        """Batch-major ``WᵀW`` lattice apply ``(B, M) → (B, M)``, fastest
        available form: the 3^d stencil (point dimension eliminated —
        ops/interp_stencil.py), else the permutation-free windowed
        composition (ops/interp_windowed.py), else the flat-plan pair."""
        if self._wtw_op is not None:
            return self._wtw_op
        if self._w_ops is not None:
            # Sorted-point composition: W's output order is internal to
            # WᵀW, so the windowed pair composes with ZERO permutation
            # gathers in the hot loop (ops/interp_windowed.py docstring).
            mv_s, rmv_s = self._w_ops
            return lambda v_bm: rmv_s(mv_s(v_bm))
        return lambda v_bm: self._rmatvec_bm(
            interp_matvec_bm_fast(self._plan, v_bm)
        )

    def _make_lattice_ops(self, Qs, wjs, mixed16: bool = False):
        """Batch-major ``(B, M)`` closures ``(to_dual, from_dual, white)``
        with the whitened dual solved in the **Kron eigenbasis**.

        ``mixed16`` casts each Kron matvec's INPUT vector to bf16 (bf16 dots
        per pass; operator rel err ~2.5e-3) while every diagonal scaling,
        the WᵀW stencil, and the returned arrays stay f32 — the
        training-solve operating point of ``train_mixed16``.

        ``M^{-1/2} = Q·D·Qᵀ`` (``D = diag(wjs)``), so rotating the CG/SLQ
        state to eigen-coordinates ``ṽ = Qᵀv`` turns the whitener diagonal
        there and the operator into ``W̃ₑ = QᵀW̃Q = I + D·Qᵀ(WᵀW − c̄I)Q·D``
        — an orthogonal similarity: same spectrum, same log-det, and every
        inner product the NLML uses is invariant.  Each application is then
        **2** Kron matvecs + one WᵀW (vs 4 for the unrotated ``W̃``):

        - ``to_dual(u) = D ⊙ (Qᵀu)``  — lattice rhs (e.g. ``Wᵀy``) → dual
          eigen-coordinates (one Kron matvec);
        - ``from_dual(ṽ) = Q(D ⊙ ṽ)`` — dual solution → lattice vector to
          feed ``W`` (one Kron matvec; note ``M^{-1/2} = from_dual∘Qᵀ ==
          Q∘to_dual``);
        - ``white(ṽ) = ṽ + to_dual(WᵀW·u − c̄·u)``, ``u = from_dual(ṽ)``.
        """
        cbar = self._lattice_cbar()
        QsT = tuple(Q.T for Q in Qs)
        prec = jax.lax.Precision.HIGHEST
        wd = wjs.dtype
        _mv_in = (lambda t: t.astype(jnp.bfloat16)) if mixed16 else (lambda t: t)

        def to_dual(v_bm):
            B = v_bm.shape[0]
            t = _mv_in(v_bm.reshape(-1))
            eyeB = jnp.eye(B, dtype=t.dtype)
            t = kron_matvec_fast((eyeB, *QsT), t, precision=prec).reshape(B, -1)
            return t.astype(wd) * wjs[None, :]

        def from_dual(v_bm):
            B = v_bm.shape[0]
            # eyeB must match the CONTRACTED vector's dtype, which is the
            # v_bm·wjs product's (promoted — a bf16 solver-state input still
            # yields an f32 t here).
            t = _mv_in((v_bm * wjs[None, :]).reshape(-1))
            eyeB = jnp.eye(B, dtype=t.dtype)
            return kron_matvec_fast(
                (eyeB, *Qs), t, precision=prec
            ).reshape(B, -1).astype(wd)

        wtw = self._wtw_bm_op()

        def white(v_bm):
            u = from_dual(v_bm)
            return v_bm + to_dual(wtw(u) - cbar * u)

        # Batch extents B > 8, B % 8 != 0 pad-and-slice through
        # ops/batching.py (exact: linear operators, zero rows).
        return (
            safe_batch_op(to_dual),
            safe_batch_op(from_dual),
            safe_batch_op(white),
        )

    def _solve_bm_lattice(self, factors, sigma2, rhs_bm):
        """Data-space solve ``Â⁻¹ rhs`` via the whitened lattice dual:
        ``Â⁻¹r = (r − W M^{-1/2} W̃⁻¹ M^{-1/2} Wᵀ r)/σ²``."""
        o = self._opts
        Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
        to_dual, from_dual, white = self._make_lattice_ops(Qs, wjs)
        u = to_dual(self._rmatvec_bm(rhs_bm))  # (B, M) eigen-coordinates
        gam = cg_solve(
            white, u, tol=o["cg_tol"], max_iters=o["cg_iters"], layout="bm",
            implicit_diff=False,
        )
        corr = self._w_bm(from_dual(gam))  # (B, n)
        return (rhs_bm - corr) / sigma2

    def _loss_lattice(self, params):
        """NLML via the lattice dual (see :meth:`_lattice_spectra`), with the
        same BBMM stop-gradient surrogate pattern as :meth:`_loss`: the
        closed-form terms ``(n−M)·logσ² + Σlog(σ²+c̄λ)`` differentiate
        exactly; only ``log|W̃|`` uses the Hutchinson surrogate."""
        o = self._opts
        n = self.x.shape[0]
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        sigma2 = jnp.exp(params["log_noise"])
        factors = cov_grid(params["kernels"], self.xg, dim_noise_var=self.dim_noise_var)
        Qs, wjs, ld_MK = self._lattice_spectra(factors, sigma2)
        to_dual, _, white = self._make_lattice_ops(Qs, wjs)

        vt = to_dual(self._rmatvec_bm(self.y[None, :]))  # ṽ = D·Qᵀ(Wᵀy)
        z = jax.random.rademacher(
            self._key, (o["num_probes"], M), dtype=self.y.dtype
        )
        sol = cg_solve(
            white, jnp.concatenate([vt, z], axis=0), tol=o["cg_tol"],
            max_iters=o["cg_iters"], layout="bm", implicit_diff=False,
        )
        gam = lax.stop_gradient(sol[0])
        S = lax.stop_gradient(sol[1:])

        yy = jnp.dot(self.y, self.y)
        quad = (
            yy - 2.0 * jnp.dot(vt[0], gam) + jnp.dot(gam, white(gam[None, :])[0])
        ) / sigma2
        ld_white = lax.stop_gradient(
            slq_logdet(
                white, M, key=jax.random.fold_in(self._key, 1),
                num_probes=o["num_probes"], lanczos_iters=o["lanczos_iters"],
                dtype=self.y.dtype, layout="bm",
            )
        )
        g_sur = jnp.sum(S * white(z)) / o["num_probes"]
        ld = (
            (n - M) * params["log_noise"]
            + ld_MK
            + ld_white
            + g_sur
            - lax.stop_gradient(g_sur)
        )
        return 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))

    def _solve_bm(self, factors, sigma2, rhs_bm, pre=None):
        """Batch-major CG solve of ``(K̂+σ²I) X = rhs`` — ``rhs_bm (B, n)``,
        honoring cg_precision ("exact" or iterative-refined "mixed") and the
        rank-r deflation preconditioner when ``precond_rank > 0`` (``pre``
        lets callers share one built preconditioner across solve + SLQ)."""
        o = self._opts
        if self.solver == "lattice":
            return self._solve_bm_lattice(factors, sigma2, rhs_bm)
        if pre is None:
            pre = self._build_precond(factors, sigma2)
        M_inv = pre[0] if pre is not None else None
        # safe_batch_op: the default NLML solve iterates at B = 1+num_probes
        # (17) and exact-variance predicts at B = chunk — padded extents
        # (ops/batching.py), like the segmented paths.
        mv = safe_batch_op(self._matvec_bm(factors, sigma2))
        if M_inv is not None:
            M_inv = safe_batch_op(M_inv)
        if o["cg_precision"] == "mixed":
            from gp_grief_jax.ops.cg import cg_solve_refined

            # Inner loop: DEFAULT-precision Kron matvec + EXACT slot-gather interp.
            # The cumsum interp form (fast=True) is 1.35× quicker per
            # application but its ~5e-5 error is *biased* and survives
            # refinement.  Note: with interp ~20× the Kron matvec inside the
            # SKI operator, "mixed" saves ~nothing here and its restarted
            # inner CG converges less per total iteration than straight
            # exact CG — prefer cg_precision="exact" (the default) for SKI.
            # Kept for API symmetry with the dense and GRIEF iterative
            # paths, where the matvec IS the low-precision cost.
            mv_fast = safe_batch_op(self._matvec_bm(
                factors, sigma2, precision=lax.Precision.DEFAULT
            ))
            if pre is not None:
                # Whitened-basis refinement — the data-space M⁻¹ hook keeps
                # the σ² < ε_f32·λmax freeze; whiten the
                # fast AND exact operators instead (the HIGHEST-precision
                # M^{-1/2} applications are cheap next to the matvec).
                M_inv_sqrt_ = pre[1]
                solw = cg_solve_refined(
                    safe_batch_op(lambda vv: M_inv_sqrt_(mv_fast(M_inv_sqrt_(vv)))),
                    safe_batch_op(lambda vv: M_inv_sqrt_(mv(M_inv_sqrt_(vv)))),
                    M_inv_sqrt_(rhs_bm),
                    tol=max(o["cg_tol"], 1e-7), inner_iters=50,
                    max_restarts=max(1, o["cg_iters"] // 50),
                    layout="bm",
                )
                return M_inv_sqrt_(solw)
            return cg_solve_refined(
                mv_fast, mv, rhs_bm,
                tol=max(o["cg_tol"], 1e-7), inner_iters=50,
                max_restarts=max(1, o["cg_iters"] // 50),
                layout="bm",
            )
        # implicit_diff=False: the NLML stop-gradients these solutions and
        # differentiates through BBMM surrogates, and predict never
        # differentiates, so the implicit-adjoint wrapper buys nothing.
        if pre is not None:
            # Whitened-basis solve (Â⁻¹r = M⁻½W̃⁻¹M⁻½r): data-space PCG
            # freezes whenever σ² < ε_f32·λmax — trained optima routinely
            # get there.
            M_inv_sqrt_ = pre[1]
            solw = cg_solve(
                safe_batch_op(lambda vv: M_inv_sqrt_(mv(M_inv_sqrt_(vv)))),
                M_inv_sqrt_(rhs_bm), tol=o["cg_tol"], max_iters=o["cg_iters"],
                layout="bm", implicit_diff=False,
            )
            return M_inv_sqrt_(solw)
        return cg_solve(
            mv, rhs_bm, tol=o["cg_tol"], max_iters=o["cg_iters"], M_inv=M_inv,
            layout="bm", implicit_diff=False,
        )

    def _solve(self, factors, sigma2, rhs):
        """Column-layout solve wrapper (``(n,)`` / ``(n, B)`` rhs)."""
        if rhs.ndim == 1:
            return self._solve_bm(factors, sigma2, rhs[None, :])[0]
        return self._solve_bm(factors, sigma2, rhs.T).T

    def kernel_matvec(self, v):
        """``(K̂ + σ²I) v`` at the current parameters."""
        factors = cov_grid(self.params["kernels"], self.xg, dim_noise_var=self.dim_noise_var)
        return self._matvec(factors, jnp.exp(self.params["log_noise"]))(v)

    # -- NLML (CG + SLQ with BBMM surrogate gradients) --------------------------

    def _loss(self, params):
        if self.solver == "lattice":
            return self._loss_lattice(params)
        # Fully batch-major: every CG/SLQ state block is (B, n) (see
        # _matvec_bm).
        n = self.x.shape[0]
        sigma2 = jnp.exp(params["log_noise"])
        factors = cov_grid(params["kernels"], self.xg, dim_noise_var=self.dim_noise_var)
        mv = self._matvec_bm(factors, sigma2)
        o = self._opts

        pre = self._build_precond(factors, sigma2)
        z = jax.random.rademacher(self._key, (o["num_probes"], n), dtype=self.y.dtype)
        rhs = jnp.concatenate([self.y[None, :], z], axis=0)
        sol = self._solve_bm(factors, sigma2, rhs, pre=pre)
        alpha = lax.stop_gradient(sol[0])
        S = lax.stop_gradient(sol[1:])

        quad = 2.0 * jnp.dot(self.y, alpha) - jnp.dot(alpha, mv(alpha[None, :])[0])
        # SLQ must run on the EXACT operator (the plan's slot-gather or
        # one-hot form, rel ≤ 1.4e-7): a δA of even ~5e-5 (the cumsum
        # interp's rounding) perturbs log|A| by tr(A⁻¹δA) — κ-amplified to a
        # ~1% NLML error (measured, n=100k).  Unlike CG there is no outer
        # refresh to erase inner-operator error.  With the deflation
        # preconditioner, SLQ runs *whitened*:
        # log|A| = log|M| + log|M⁻½AM⁻½| — the whitened spectrum clusters at
        # 1, so the quadrature converges in a handful of nodes (same pattern
        # as GPGriefModel.log_likelihood_iterative).
        if pre is not None:
            M_inv_sqrt, logdet_M = pre[1], pre[2]
            slq_mv = safe_batch_op(
                lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))
            )
            ld_off = logdet_M
        else:
            slq_mv, ld_off = safe_batch_op(mv), 0.0
        ld_val = lax.stop_gradient(
            ld_off
            + slq_logdet(
                slq_mv, n, key=jax.random.fold_in(self._key, 1),
                num_probes=o["num_probes"], lanczos_iters=o["lanczos_iters"],
                dtype=self.y.dtype, layout="bm",
            )
        )
        g_sur = jnp.sum(S * mv(z)) / o["num_probes"]
        ld = ld_val + g_sur - lax.stop_gradient(g_sur)
        return 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))

    def log_likelihood_segmented(
        self,
        *,
        cg_segment_iters: int = 60,
        probe_chunk: int = 8,
        fuse_probes: bool = True,
        verbose: bool = False,
    ) -> float:
        """Log marginal likelihood via host-segmented CG + probe-chunked SLQ.

        Same estimator as :meth:`log_likelihood` (identical quadratic form
        and whitened-SLQ log-det; the SLQ probe draw is chunk-partitioned so
        the two agree within SLQ sampling error), but no single device
        program runs more than ``cg_segment_iters`` CG iterations or
        ``probe_chunk × lanczos_iters`` Lanczos matvecs
        (:func:`gp_grief_jax.ops.cg.cg_solve_segmented`).  Value-only (no
        gradients).

        Compile-once: the (init, segment, quad, slq-chunk) programs are
        built and jitted ONCE per ``(solver, cg_segment_iters, probe_chunk,
        num_probes, lanczos_iters, fuse_probes)`` and cached on the model —
        parameters and the evaluation's spectra/preconditioner are explicit
        program ARGUMENTS (same pattern as :meth:`_build_step_programs`), so
        repeated NLML evaluations cost device time + one dispatch per
        segment, with no per-call retrace (a per-call program rebuild costs
        seconds of host time per 1M-point evaluation).

        ``fuse_probes`` (default True): run the SLQ probe chunks FIRST,
        each fused with ``lanczos_iters`` CG iterations through one
        ``(1+R, m)`` operator application per iteration
        (:func:`gp_grief_jax.ops.fused.fused_cg_slq_segment`) — the hot
        applies cost nearly the same at B=2 and B=9, so the probe passes
        advance the CG solve for free; leftover CG segments then run
        to convergence.  Same probe draws and recurrence arithmetic as the
        separate passes (estimator family unchanged).
        """
        o = self._opts
        n = int(self.x.shape[0])
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        lattice = self.solver == "lattice"
        progs = self._nlml_programs(
            int(cg_segment_iters), int(probe_chunk), bool(fuse_probes)
        )
        ((init_fn, init_c), (seg_fn, seg_c), (fin_fn, fin_c), slq_progs,
         fused_progs, sizes) = progs

        aux, rhs, state, bnorm, rnorm = init_fn(init_c, self.params)
        eff_tol = max(float(o["cg_tol"]), 20.0 * float(jnp.finfo(self.y.dtype).eps))
        stop = eff_tol * np.maximum(
            np.asarray(bnorm), float(jnp.finfo(self.y.dtype).tiny)
        )
        rnorm_h = np.asarray(rnorm)
        dead_h = np.zeros(rnorm_h.shape, bool)
        iters = 0
        key1 = jax.random.fold_in(self._key, 1)
        total = 0.0
        if fused_progs is not None:
            for c, rr in enumerate(sizes):
                fp, fc = fused_progs[rr]
                state, rnorm, dead, ld_c = fp(
                    fc, aux, state, jax.random.fold_in(key1, c)
                )
                total += float(ld_c) * rr
                rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
                iters += int(o["lanczos_iters"])
                if verbose:
                    rel = float(
                        np.max(rnorm_h / np.maximum(np.asarray(bnorm), 1e-30))
                    )
                    print(
                        f"[nlml_segmented] fused chunk {c + 1}: iters={iters} "
                        f"max_rel_resid={rel:.3e}"
                    )
        max_segments = max(1, -(-max(0, o["cg_iters"] - iters) // cg_segment_iters))
        for s in range(max_segments):
            if not np.any((rnorm_h > stop) & ~dead_h):
                break
            state, rnorm, dead = seg_fn(seg_c, aux, state)
            # The per-segment fetch is the host-side convergence test; it
            # also bounds the async queue at one segment.
            rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
            iters += cg_segment_iters
            if verbose:
                rel = float(np.max(rnorm_h / np.maximum(np.asarray(bnorm), 1e-30)))
                print(
                    f"[nlml_segmented] segment {s + 1}: iters={iters} "
                    f"max_rel_resid={rel:.3e}"
                )
        pieces = fin_fn(fin_c, aux, rhs, state)
        if fused_progs is None:
            for c, rr in enumerate(sizes):
                sp, sc = slq_progs[rr]
                # Per-chunk fetch bounds the device queue at one chunk; the
                # fold_in(key1, c) draw matches ops.lanczos.
                # slq_logdet_segmented, so the estimator is identical to the
                # monolithic one's family.
                total += float(sp(sc, aux, jax.random.fold_in(key1, c))) * rr
        ld_white = total / o["num_probes"]
        if lattice:
            quad, sigma2, ld_MK = (float(v) for v in pieces)
            ld = (n - M) * float(np.log(sigma2)) + ld_MK + ld_white
        else:
            quad, ld_off = (float(v) for v in pieces)
            ld = ld_off + ld_white
        return -0.5 * (quad + ld + n * float(np.log(2.0 * np.pi)))

    def _nlml_programs(
        self, cg_segment_iters: int, probe_chunk: int, fuse_probes: bool = True
    ):
        """Cached compile-once programs for :meth:`log_likelihood_segmented`."""
        o = self._opts
        lattice = self.solver == "lattice"
        r = 0 if lattice else self._precond_rank()
        probe_chunk = max(1, min(int(probe_chunk), int(o["num_probes"])))
        key = (
            lattice, r, int(cg_segment_iters), probe_chunk,
            int(o["num_probes"]), int(o["lanczos_iters"]), bool(fuse_probes),
        )
        if getattr(self, "_nlml_progs_key", None) != key:
            self._nlml_progs_key = key
            self._nlml_progs = self._build_nlml_programs(
                int(cg_segment_iters), probe_chunk, bool(fuse_probes)
            )
        return self._nlml_progs

    def _build_nlml_programs(
        self, segment_iters: int, probe_chunk: int, fuse_probes: bool = True
    ):
        """Compile-once (init, segment, quad, slq-chunk) programs for
        :meth:`log_likelihood_segmented` — the NLML analog of
        :meth:`_build_step_programs`.  Hyperparameters and the evaluation's
        spectra are threaded through an ``aux`` pytree of explicit program
        arguments; every closure-captured array (interp plans, ``y``) is
        hoisted by :func:`gp_grief_jax.utils.closure.explicit_closure`
        instead of being embedded as program constants.
        """
        from gp_grief_jax.ops.cg import _make_pcg_step, _reducers
        from gp_grief_jax.utils.closure import explicit_closure

        o = self._opts
        n = int(self.x.shape[0])
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        lattice = self.solver == "lattice"
        dim = M if lattice else n
        r = 0 if lattice else self._precond_rank()
        if lattice:
            self._lattice_cbar()  # host-side, outside any trace
        _colsum, _colnorm, _bc = _reducers("bm", None)

        def build_op(aux):
            """The CG/SLQ operator (whitened where applicable) from ``aux``."""
            if lattice:
                _, Qs, wjs, _ = aux
                _, _, white = self._make_lattice_ops(Qs, wjs)
                return white
            factors, sigma2, U, lam = aux
            mv = self._matvec_bm(factors, sigma2)
            if U is None:
                return safe_batch_op(mv)
            _, M_inv_sqrt, _ = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
            # Whitened-basis operator — data-space PCG freezes whenever
            # σ² < ε_f32·λmax, the exact regime this method targets; same
            # composition as _solve_bm.  safe_batch_op: ops/batching.py.
            return safe_batch_op(lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv))))

        def init_fn(params):
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            if lattice:
                Qs, wjs, ld_MK = self._lattice_spectra(factors, sigma2)
                aux = (sigma2, Qs, wjs, ld_MK)
                to_dual, _, _ = self._make_lattice_ops(Qs, wjs)
                rhs = to_dual(self._rmatvec_bm(self.y[None, :]))  # ṽ = D·Qᵀ(Wᵀy)
            else:
                U, lam = (
                    self._precond_spectral(factors, r) if r > 0 else (None, None)
                )
                aux = (factors, sigma2, U, lam)
                rhs = self.y[None, :]
                if U is not None:
                    _, M_inv_sqrt, _ = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
                    rhs = M_inv_sqrt(rhs)
            # x0 = 0 → r0 = rhs exactly (the operators are linear), so the
            # init matvec is skipped; no inner preconditioner in the
            # whitened space.
            x0 = jnp.zeros_like(rhs)
            rz0 = _colsum(rhs * rhs)
            state = (x0, rhs, rhs, rhs, rz0, jnp.zeros(rz0.shape, bool))
            return aux, rhs, state, _colnorm(rhs), _colnorm(rhs)

        def seg_fn(aux, state):
            op = build_op(aux)
            step = _make_pcg_step(op, lambda rr_: rr_, _colsum, _bc)

            def body(s, _):
                return step(*s), None

            state, _ = lax.scan(body, state, None, length=segment_iters)
            return state, _colnorm(state[1]), state[5]

        def fin_fn(aux, rhs, state):
            """Quadratic-form pieces from the converged solve."""
            if lattice:
                sigma2, Qs, wjs, ld_MK = aux
                _, _, white = self._make_lattice_ops(Qs, wjs)
                gam = state[0]
                quad = (
                    jnp.dot(self.y, self.y)
                    - 2.0 * jnp.dot(rhs[0], gam[0])
                    + jnp.dot(gam[0], white(gam)[0])
                ) / sigma2
                return quad, sigma2, ld_MK
            factors, sigma2, U, lam = aux
            mv = self._matvec_bm(factors, sigma2)
            if U is not None:
                _, M_inv_sqrt, ldM = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
                alpha = M_inv_sqrt(state[0])
                ld_off = ldM
            else:
                alpha = state[0]
                ld_off = jnp.zeros((), dtype=self.y.dtype)
            quad = 2.0 * jnp.dot(self.y, alpha[0]) - jnp.dot(alpha[0], mv(alpha)[0])
            return quad, ld_off

        sizes = [probe_chunk] * (int(o["num_probes"]) // probe_chunk)
        if int(o["num_probes"]) % probe_chunk:
            sizes.append(int(o["num_probes"]) % probe_chunk)

        def make_slq(rr):
            def slq_fn(aux, k):
                return slq_logdet(
                    build_op(aux), dim, key=k, num_probes=rr,
                    lanczos_iters=int(o["lanczos_iters"]), dtype=self.y.dtype,
                    layout="bm",
                )

            return slq_fn

        def make_fused(rr):
            # SLQ probe chunk + CG advance sharing every operator apply
            # (ops/fused.py) — same Rademacher draw as make_slq's
            # slq_logdet, so the log-det estimator family is unchanged.
            from gp_grief_jax.ops.fused import fused_cg_slq_segment

            def fused_fn(aux, state, k):
                op = build_op(aux)
                Z = jax.random.rademacher(k, (rr, dim), dtype=self.y.dtype)
                state2, ld = fused_cg_slq_segment(
                    op, state, Z, int(o["lanczos_iters"])
                )
                return state2, _colnorm(state2[1]), state2[5], ld

            return fused_fn

        sds = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), t
        )
        ip, ic = explicit_closure(init_fn, sds(self.params))
        out_sds = jax.eval_shape(ip, ic, sds(self.params))
        aux_sds, rhs_sds, state_sds = out_sds[0], out_sds[1], out_sds[2]
        sp, sc = explicit_closure(seg_fn, aux_sds, state_sds)
        fp, fc = explicit_closure(fin_fn, aux_sds, rhs_sds, state_sds)
        key0 = jax.random.PRNGKey(0)
        key_sds = jax.ShapeDtypeStruct(key0.shape, key0.dtype)
        slq_progs = None
        fused_progs = None
        if fuse_probes:
            fused_progs = {
                rr: (lambda qp_qc: (jax.jit(qp_qc[0]), qp_qc[1]))(
                    explicit_closure(make_fused(rr), aux_sds, state_sds, key_sds)
                )
                for rr in sorted(set(sizes))
            }
        else:
            slq_progs = {
                rr: (lambda qp_qc: (jax.jit(qp_qc[0]), qp_qc[1]))(
                    explicit_closure(make_slq(rr), aux_sds, key_sds)
                )
                for rr in sorted(set(sizes))
            }
        return (
            (jax.jit(ip), ic),
            (jax.jit(sp), sc),
            (jax.jit(fp), fc),
            slq_progs,
            fused_progs,
            sizes,
        )

    def optimize_segmented(
        self,
        *,
        max_iters: int = 30,
        learning_rate: float = 0.05,
        num_probes: int = 4,
        cg_segment_iters: int = 50,
        verbose: bool = False,
    ):
        """Adam training with bounded-program steps (the n ≳ 1M scale).

        A monolithic ``value_and_grad`` step at n=1M runs hundreds of
        operator applications in ONE device program — past the ~60 s
        per-program execution limit.  Here each step decomposes into
        bounded programs:

        1. the CG solves for ``y`` and the ``num_probes`` Hutchinson
           gradient probes run host-SEGMENTED (lattice-dual or whitened
           data-space per ``solver``);
        2. ONE bounded jitted program evaluates the BBMM surrogate
           objective with the solves injected as fixed inputs and
           autodiffs it — by construction the same gradient as
           ``jax.grad(self._loss)`` with matching probe draws (the SLQ
           log-det VALUE carries no gradient and is skipped);
        3. the Adam update runs eagerly on host.

        The returned ``losses`` trace is the surrogate objective (NLML
        minus the stop-grad log-det value) — monotone trends are
        meaningful, absolute values are not; use
        :meth:`log_likelihood_segmented` for true NLML.
        """
        import optax

        from gp_grief_jax.utils.closure import explicit_closure

        o = self._opts
        n = int(self.x.shape[0])
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        R = int(num_probes)
        lattice = self.solver == "lattice"
        if lattice:
            self._lattice_cbar()

        def surrogate(params, sol, z):
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            yy = jnp.dot(self.y, self.y)
            if lattice:
                Qs, wjs, ld_MK = self._lattice_spectra(factors, sigma2)
                to_dual, _, white = self._make_lattice_ops(Qs, wjs)
                vt = to_dual(self._rmatvec_bm(self.y[None, :]))
                gam, S = sol[0], sol[1:]
                quad = (
                    yy - 2.0 * jnp.dot(vt[0], gam)
                    + jnp.dot(gam, white(gam[None, :])[0])
                ) / sigma2
                g_sur = jnp.sum(S * white(z)) / R
                ld_part = (n - M) * params["log_noise"] + ld_MK + g_sur
            else:
                mv = self._matvec_bm(factors, sigma2)
                alpha, S = sol[0], sol[1:]
                quad = 2.0 * jnp.dot(self.y, alpha) - jnp.dot(
                    alpha, mv(alpha[None, :])[0]
                )
                g_sur = jnp.sum(S * mv(z)) / R
                ld_part = g_sur
            return 0.5 * (quad + ld_part + n * jnp.log(2.0 * jnp.pi))

        dim = M if lattice else n
        sds = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), t
        )
        sol_sds = jax.ShapeDtypeStruct((1 + R, dim), self.y.dtype)
        z_sds = jax.ShapeDtypeStruct((R, dim), self.y.dtype)
        # The surrogate value_and_grad program is cached on the model like
        # the step-solve programs: rebuilding it per optimize_segmented call
        # costs a retrace + (persistent-cache) compile lookup per call.
        if getattr(self, "_segvg_key", None) != (R, lattice):
            sur_pure, sur_consts = explicit_closure(
                surrogate, sds(self.params), sol_sds, z_sds
            )
            self._segvg_key = (R, lattice)
            self._segvg = (
                jax.jit(
                    lambda consts, p, sol, z: jax.value_and_grad(
                        lambda pp: sur_pure(consts, pp, sol, z)
                    )(p)
                ),
                sur_consts,
            )
        vg, sur_consts = self._segvg

        opt = optax.adam(learning_rate)
        state = opt.init(self.params)
        losses = []
        import time as _time

        t0 = _time.perf_counter()
        for it in range(max_iters):
            key_t = jax.random.fold_in(self._key, 1000 + it)
            t_s = _time.perf_counter()
            sol, z = self._segmented_step_solves(
                self.params, key_t, R, cg_segment_iters
            )
            t_solve = _time.perf_counter() - t_s
            t_s = _time.perf_counter()
            val, grad = vg(sur_consts, self.params, sol, z)
            losses.append(float(val))  # sync point: vg wall is honest
            t_vg = _time.perf_counter() - t_s
            updates, state = opt.update(grad, state, self.params)
            self.params = optax.apply_updates(self.params, updates)
            if verbose:
                print(
                    f"[optimize_segmented] iter {it + 1:3d} "
                    f"surrogate {losses[-1]:.4f} "
                    f"(solves {t_solve:.2f} s, grad {t_vg:.2f} s)",
                    flush=True,
                )
        from gp_grief_jax.optimize import FitResult

        return FitResult(
            params=self.params,
            losses=np.asarray(losses),
            grad_norms=np.full(len(losses), np.nan),
            iterations=len(losses),
            wall_time=_time.perf_counter() - t0,
            converged=False,
        )

    def _segmented_step_solves(self, params, key, R, cg_segment_iters):
        """One training step's solves, host-segmented: returns
        ``(sol (1+R, dim), z (R, dim))`` — the y-solve plus the Hutchinson
        probe solves in the solver's working space (lattice γ's or
        data-space α's).

        The init/segment/finish programs are built and compiled ONCE per
        ``(R, cg_segment_iters)`` and reused across Adam steps: parameters
        and the step's spectra are explicit program ARGUMENTS (an ``aux``
        pytree threaded through the CG state), so no retrace or recompile
        happens per step (round-2 review finding)."""
        o = self._opts
        lattice = self.solver == "lattice"
        cache_key = (R, cg_segment_iters, lattice, self._train_mixed16)
        if getattr(self, "_segtrain_key", None) != cache_key:
            self._segtrain_key = cache_key
            self._segtrain_progs = self._build_step_programs(R, cg_segment_iters)
        init_p, seg_p, fin_p = self._segtrain_progs
        init_fn, init_c = init_p
        seg_fn, seg_c = seg_p
        fin_fn, fin_c = fin_p

        aux, state, bnorm, rnorm, z = init_fn(init_c, params, key)
        eff_tol = max(float(o["cg_tol"]), 20.0 * float(jnp.finfo(self.y.dtype).eps))
        stop = eff_tol * np.maximum(np.asarray(bnorm), float(jnp.finfo(self.y.dtype).tiny))
        rnorm_h = np.asarray(rnorm)
        dead_h = np.zeros(rnorm_h.shape, bool)
        max_segments = max(1, -(-o["cg_iters"] // cg_segment_iters))
        for _ in range(max_segments):
            if not np.any((rnorm_h > stop) & ~dead_h):
                break
            prev = rnorm_h
            state, rnorm, dead = seg_fn(seg_c, aux, state)
            rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
            # Stagnation stop: a segment that shrinks no column's residual
            # by ≥1.2× is at its arithmetic floor (bf16 training solves sit
            # at ~3.6e-3 relative, unreachable by the f32-grade stop above)
            # — further segments only burn wall time.
            if not np.any(rnorm_h < prev / 1.2):
                break
        return fin_fn(fin_c, aux, state), z

    def _build_step_programs(self, R, segment_iters):
        """Compile-once (init, segment, finish) programs for
        :meth:`_segmented_step_solves` — see there."""
        from gp_grief_jax.ops.cg import _make_pcg_step, _reducers
        from gp_grief_jax.utils.closure import explicit_closure

        n = int(self.x.shape[0])
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        lattice = self.solver == "lattice"
        # Mixed16 training solves apply only to the lattice dual: its
        # whitened operator clusters at 1, so a bf16 stagnation floor of
        # ~3e-3 is benign; the raw data-space operator is κ ≳ 1/ε_f32 where
        # mixed precision and deflation do not compose.
        mixed = self._train_mixed16 and lattice
        dim = M if lattice else n
        r = 0 if lattice else self._precond_rank()
        _colsum, _colnorm, _bc = _reducers("bm", None)

        def build_op(aux):
            """(operator, unwhiten) from the step's spectra pytree.
            safe_batch_op: ops/batching.py."""
            if lattice:
                Qs, wjs = aux
                _, _, white = self._make_lattice_ops(Qs, wjs, mixed16=mixed)
                return white, (lambda s: s)
            factors, sigma2, U, lam = aux
            mv = self._matvec_bm(factors, sigma2)
            if U is None:
                return safe_batch_op(mv), (lambda s: s)
            _, M_inv_sqrt, _ = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
            return (
                safe_batch_op(lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))),
                M_inv_sqrt,
            )

        def init_fn(params, key):
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            z = jax.random.rademacher(key, (R, dim), dtype=self.y.dtype)
            if lattice:
                Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
                aux = (Qs, wjs)
                to_dual, _, _ = self._make_lattice_ops(Qs, wjs)
                rhs = jnp.concatenate(
                    [to_dual(self._rmatvec_bm(self.y[None, :])), z], axis=0
                )
            else:
                U, lam = (
                    self._precond_spectral(factors, r) if r > 0 else (None, None)
                )
                aux = (factors, sigma2, U, lam)
                rhs = jnp.concatenate([self.y[None, :], z], axis=0)
                if U is not None:
                    _, M_inv_sqrt, _ = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
                    rhs = M_inv_sqrt(rhs)
            # x0 = 0 → r0 = rhs; no inner preconditioner in the whitened space.
            x0 = jnp.zeros_like(rhs)
            rz0 = _colsum(rhs * rhs)
            state = (x0, rhs, rhs, rhs, rz0, jnp.zeros(rz0.shape, bool))
            return aux, state, _colnorm(rhs), _colnorm(rhs), z

        def seg_fn(aux, state):
            op, _ = build_op(aux)
            if mixed:
                from gp_grief_jax.ops.cg import _segment_scan_mixed

                state = _segment_scan_mixed(
                    op, state, segment_iters, _colsum, _bc, jnp.bfloat16
                )
            else:
                step = _make_pcg_step(op, lambda rr: rr, _colsum, _bc)

                def body(s, _):
                    return step(*s), None

                state, _ = lax.scan(body, state, None, length=segment_iters)
            return state, _colnorm(state[1]), state[5]

        def fin_fn(aux, state):
            _, unw = build_op(aux)
            return unw(state[0])

        sds = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), t
        )
        key0 = jax.random.PRNGKey(0)
        ip, ic = explicit_closure(
            init_fn, sds(self.params), jax.ShapeDtypeStruct(key0.shape, key0.dtype)
        )
        out_sds = jax.eval_shape(ip, ic, sds(self.params),
                                 jax.ShapeDtypeStruct(key0.shape, key0.dtype))
        aux_sds, state_sds = out_sds[0], out_sds[1]
        sp, sc = explicit_closure(seg_fn, aux_sds, state_sds)
        fp, fc = explicit_closure(fin_fn, aux_sds, state_sds)
        return (
            (jax.jit(ip), ic),
            (jax.jit(sp), sc),
            (jax.jit(fp), fc),
        )

    # -- prediction --------------------------------------------------------------

    @staticmethod
    def _prior_diag(factors, iw_c):
        """Diagonal of the SKI prior at test points — factorizes over dims:
        ``k̂(x*,x*)_tt = Π_d Σ_{o,o'} w_d[t,o]·K_d[i+o,i+o']·w_d[t,o']``;
        O(n*·4d), never (n*, n*)."""
        prior = None
        for d_, Kd in enumerate(factors):
            m_d = Kd.shape[0]
            i0 = iw_c.idx[d_]
            w2 = iw_c.w[d_]  # (c, 2)
            s = None
            for a in (0, 1):
                for b in (0, 1):
                    ia = jnp.minimum(i0 + a, m_d - 1)
                    ib = jnp.minimum(i0 + b, m_d - 1)
                    term = w2[:, a] * Kd[ia, ib] * w2[:, b]
                    s = term if s is None else s + term
            prior = s if prior is None else prior * s
        return prior

    def predict(
        self,
        x_new,
        compute_var: bool = True,
        include_noise: bool = False,
        chunk: int = 0,
        variance: str = "exact",
        var_rank: int = 100,
        love_check: int = 8,
        love_tol: float = 0.1,
        love_on_fail: str = "exact",
    ):
        """Predictive mean and variance.

        ``variance="exact"``: CGs the ``(n, c)`` cross-covariance columns of
        one test *chunk* at a time, never materializing ``(n, n*)`` — SKI at
        n=100k with 10k test points stays at ``n·c``.  Chunks run as a HOST
        loop over one compiled per-chunk program (not ``lax.map``): each
        chunk's CG is a separate device execution, so arbitrarily many test
        points stay within bounded programs.  ``chunk=0``
        auto-sizes from ``n + m``.  Cost: one c-rhs CG per chunk — exact but
        expensive at large n.

        ``variance="lanczos"``: LOVE-style fast variances (Pleiss et al.
        2018, adapted to the SKI lattice).  ONE ``var_rank``-step
        full-reorthogonalized Lanczos run on ``Ã = K̂+σ²I`` from ``v₀ = y``
        gives ``Ã⁻¹ ≈ Q T⁻¹ Qᵀ`` on the Krylov space; the per-chunk work
        collapses to interpolating the precomputed ``S = (QᵀW K) (r, M)``
        lattice rows at the test points — no CG per chunk, O(c·r·2^d).
        Approximate from below (variances are over-estimated by the
        truncation, never negative-biased), converging in ``var_rank``;
        the mean is unaffected.

        Under ``solver='lattice'`` both paths run entirely in the whitened
        dual (no σ² division, no data-space operator): the mean representer
        is ``K Wᵀ Â⁻¹ y ≡ B⁻¹ Wᵀy`` and the exact variance reduction is
        ``w*ᵀ K (WᵀW) B⁻¹ w*`` — identities verified to 1e-14 (see _prep).
        Dual LOVE models the off-span inverse as the identity (the whitened
        cluster value); exact at ``var_rank = M``, but at small ranks on
        large lattices the residual is a fraction of the PRIOR variance set
        by the whitened spectral spread — prefer ``variance='exact'`` (an
        M-dim whitened CG per chunk, cheaper than the old n-dim form) when
        variance accuracy matters.

        Because that degradation is silent, LOVE predictions carry an
        on-the-fly guard (round-3 weak #1): the first ``love_check`` test
        points are ALSO pushed through the exact route and compared; a max
        relative variance deviation above ``love_tol`` triggers the
        ``love_on_fail`` policy (round-4 weak #3 — warnings are routinely
        swallowed in pipelines, and the failure mode is silently-wrong
        uncertainty):

        - ``"exact"`` (default): warn, then AUTO-UPGRADE — recompute the
          prediction through the exact variance route and return that.
        - ``"warn"``: warn and return the degraded LOVE variances anyway.
        - ``"raise"``: raise ``RuntimeError`` naming the measured error.

        ``love_check=0`` disables the guard (and its one extra small
        compiled program)."""
        if variance not in ("exact", "lanczos"):
            raise ValueError("variance must be 'exact' or 'lanczos'")
        if love_on_fail not in ("exact", "warn", "raise"):
            raise ValueError("love_on_fail must be 'exact', 'warn' or 'raise'")
        x_new = jnp.asarray(x_new, dtype=self.x.dtype)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = np.zeros((0,), dtype=np.asarray(self.y).dtype)
            return empty if not compute_var else (empty, empty.copy())
        n = int(self.x.shape[0])
        m = int(np.prod([g.shape[0] for g in self.xg]))
        # LOVE's Krylov space is n-dimensional for the data solver but
        # M-dimensional in the whitened dual.
        var_rank = int(min(var_rank, m if self.solver == "lattice" else n))
        if chunk <= 0:
            if variance == "lanczos" and compute_var:
                chunk = int(max(1, min(n_star, 4096)))
            else:
                chunk = int(max(1, min(n_star, max(8, (1 << 26) // max(n + m, 1)))))
        chunk = min(chunk, n_star)
        n_pad = -(-n_star // chunk) * chunk
        if n_pad != n_star:
            x_pad = jnp.concatenate(
                [x_new, jnp.broadcast_to(x_new[:1], (n_pad - n_star, x_new.shape[1]))]
            )
        else:
            x_pad = x_new
        guard_k = (
            int(min(love_check, n_star))
            if (variance == "lanczos" and compute_var)
            else 0
        )
        cache_key = (chunk, bool(compute_var), variance, var_rank, guard_k)
        if getattr(self, "_predict_key", None) != cache_key:
            self._predict_key = cache_key

            o = self._opts

            def _prep(params):
                sigma2 = jnp.exp(params["log_noise"])
                factors = cov_grid(params["kernels"], self.xg, dim_noise_var=self.dim_noise_var)
                if self.solver == "lattice":
                    # Mean representer WITHOUT the data-space correction:
                    # K Wᵀ Â⁻¹ y ≡ B⁻¹ (Wᵀy), B = σ²K⁻¹ + WᵀW  (from
                    # Bγ = Wᵀy ⟹ KWᵀ(y − WB⁻¹Wᵀy)/σ² = K·σ²K⁻¹γ/σ² = γ).
                    # The data-space form (r − corr)/σ² cancels catastrophically
                    # at f32 when σ² ≪ κ(K̂)·ε (measured: rmse 0.17 vs 0.009 at
                    # n=200k/32³) — the dual solve is the bounded-arithmetic
                    # regime and is also one W apply + one Kron matvec cheaper.
                    Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
                    to_dual, from_dual, white = self._make_lattice_ops(Qs, wjs)
                    vt = to_dual(self._rmatvec_bm(self.y[None, :]))
                    gam = cg_solve(
                        white, vt, tol=o["cg_tol"], max_iters=o["cg_iters"],
                        layout="bm", implicit_diff=False,
                    )
                    Kw_alpha = from_dual(gam)[0]
                    if variance != "lanczos" or not compute_var:
                        return Kw_alpha, sigma2, None, None
                    # Dual LOVE precompute: Lanczos basis of the WHITENED dual
                    # W̃ₑ from ṽ₀ = to_dual(Wᵀy); per-chunk variances project
                    # onto it (see _chunk_prog).  S := Q̃ᵀ (r, M).
                    from gp_grief_jax.ops.lanczos import lanczos

                    # lanczos's matvec contract is column-layout (M, 1).
                    res = lanczos(
                        lambda v: white(v.T).T, vt[0], var_rank,
                        full_reorth=True, store_basis=True,
                    )
                    S = res.Q.T  # (r, M) whitened-dual Krylov basis
                else:
                    alpha = self._solve(factors, sigma2, self.y)
                    Kw_alpha = kron_matvec_fast(
                        factors, interp_rmatvec(self.iw, alpha)
                    )
                    if variance != "lanczos" or not compute_var:
                        return Kw_alpha, sigma2, None, None
                    # LOVE precompute: Lanczos basis of Ã from v0 = y, then
                    # the projected lattice rows S = (Qᵀ W) K  (r, M).
                    from gp_grief_jax.ops.lanczos import lanczos

                    mv = self._matvec(factors, sigma2)
                    res = lanczos(
                        mv, self.y, var_rank, full_reorth=True, store_basis=True
                    )
                    QW = self._rmatvec_bm(res.Q.T)  # (r, M)
                    eyeR = jnp.eye(var_rank, dtype=self.y.dtype)
                    S = kron_matvec_fast((eyeR, *factors), QW.reshape(-1)).reshape(
                        var_rank, -1
                    )
                # Dense T; identity rows past breakdown (their Q columns are
                # exactly zero, so the identity block never contributes).
                valid = jnp.arange(var_rank) < res.num_valid
                diag = jnp.where(valid, res.alpha, 1.0)
                T = (
                    jnp.diag(diag)
                    + jnp.diag(res.beta, 1)
                    + jnp.diag(res.beta, -1)
                )
                Tchol = jnp.linalg.cholesky(T)
                return Kw_alpha, sigma2, S, Tchol

            def _make_chunk_prog(variance):
              # Factory over the variance mode so the LOVE guard below can
              # instantiate the EXACT branch against the same prep outputs.
              def _chunk_prog(params, Kw_alpha, S, Tchol, xc):
                sigma2 = jnp.exp(params["log_noise"])
                factors = cov_grid(params["kernels"], self.xg, dim_noise_var=self.dim_noise_var)
                iw_c = interp_weights(xc, self.xg)
                # k̂(x*, X) α = W* K (Wᵀ α)
                mean = interp_matvec(iw_c, Kw_alpha)
                if not compute_var:
                    return mean, jnp.zeros_like(mean)
                prior_diag = self._prior_diag(factors, iw_c)
                c = int(xc.shape[0])
                if self.solver == "lattice":
                    # Entirely in the whitened dual: the exact variance
                    # reduction is c_tᵀÂ⁻¹c_t ≡ w*ᵀ K (WᵀW) B⁻¹ w*  (from
                    # B⁻¹(WᵀW) = I − σ²B⁻¹K⁻¹ ⟹ (WKw*)ᵀÂ⁻¹(WKw*) =
                    # w*ᵀKG·B⁻¹w*) — no σ² division, no (c, n) data-space
                    # cross-covariance, and the CG runs on the bounded
                    # whitened operator (M-dim, not n-dim).
                    Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
                    to_dual, from_dual, white = self._make_lattice_ops(Qs, wjs)
                    Wst_bm = interp_rmatvec_bm(
                        iw_c, jnp.eye(c, dtype=self.x.dtype)
                    )  # (c, M) test interp rows w*_t
                    eyeC = jnp.eye(c, dtype=self.x.dtype)
                    wtw = self._wtw_bm_op()
                    if variance == "lanczos":
                        # Dual LOVE with the whitener as the off-span inverse:
                        # W̃⁻¹ ≈ I + Q̃(T⁻¹ − I)Q̃ᵀ  (exact on the Krylov span,
                        # the cluster value 1 elsewhere — the whitened spectrum
                        # clusters at 1, so the identity is the right tail
                        # model where plain LOVE's zero badly under-reduces).
                        # reduction_t = u2·u1 + p2ᵀT⁻¹p1 − p2ᵀp1 with
                        # u1 = to_dual(w*_t), u2 = to_dual(GKw*_t), p = Q̃ᵀu.
                        u1 = to_dual(Wst_bm)  # (c, M)
                        KW = kron_matvec_fast(
                            (eyeC, *factors), Wst_bm.reshape(-1)
                        ).reshape(c, -1)
                        u2 = to_dual(wtw(KW))  # (c, M)
                        proj1 = u1 @ S.T  # (c, r)
                        proj2 = u2 @ S.T
                        Z1 = jax.scipy.linalg.solve_triangular(
                            Tchol, proj1.T, lower=True
                        )
                        Z2 = jax.scipy.linalg.solve_triangular(
                            Tchol, proj2.T, lower=True
                        )
                        var = prior_diag - (
                            jnp.sum(u1 * u2, axis=1)
                            + jnp.sum(Z1 * Z2, axis=0)
                            - jnp.sum(proj1 * proj2, axis=1)
                        )
                        return mean, jnp.maximum(var, 0.0)
                    gam = cg_solve(
                        white, to_dual(Wst_bm), tol=o["cg_tol"],
                        max_iters=o["cg_iters"], layout="bm",
                        implicit_diff=False,
                    )
                    Ggam = wtw(from_dual(gam))  # G B⁻¹ w*_t rows (c, M)
                    KG = kron_matvec_fast(
                        (eyeC, *factors), Ggam.reshape(-1)
                    ).reshape(c, -1)
                    var = prior_diag - jnp.sum(Wst_bm * KG, axis=1)
                    return mean, jnp.maximum(var, 0.0)
                if variance == "lanczos":
                    # g_t = Qᵀ c_t = S w*_t ; var = prior − g_tᵀ T⁻¹ g_t
                    G = interp_matvec_bm(iw_c, S)  # (r, c)
                    Z = jax.scipy.linalg.solve_triangular(
                        Tchol, G, lower=True
                    )
                    var = prior_diag - jnp.sum(Z * Z, axis=0)
                    return mean, jnp.maximum(var, 0.0)
                # Exact: c_t = k̂(X, x*_t); var_t = k̂** − c_tᵀ Ã⁻¹ c_t.
                # Batch-major through the lattice (see _matvec_bm).
                Wst_bm = interp_rmatvec_bm(iw_c, jnp.eye(c, dtype=self.x.dtype))
                eyeC = jnp.eye(c, dtype=self.x.dtype)
                u = kron_matvec_fast((eyeC, *factors), Wst_bm.reshape(-1))
                C_bm = interp_matvec_bm_fast(self._plan, u.reshape(c, -1))  # (c, n)
                Sol = self._solve_bm(factors, sigma2, C_bm)
                var = prior_diag - jnp.sum(C_bm * Sol, axis=1)
                return mean, jnp.maximum(var, 0.0)

              return _chunk_prog

            _chunk_prog = _make_chunk_prog(variance)

            # Hoist closure-captured arrays (plan tables, y) into explicit
            # jit arguments instead of embedding them as program constants —
            # see gp_grief_jax.utils.closure.
            from gp_grief_jax.utils.closure import explicit_closure

            _sds = lambda t: jax.tree.map(  # noqa: E731
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t
            )
            prep_pure, prep_consts = explicit_closure(_prep, _sds(self.params))
            prep_sds = jax.eval_shape(prep_pure, prep_consts, _sds(self.params))
            chunk_pure, chunk_consts = explicit_closure(
                _chunk_prog,
                _sds(self.params),
                *(prep_sds[:1] + prep_sds[2:]),
                jax.ShapeDtypeStruct((chunk, int(x_pad.shape[1])), x_pad.dtype),
            )
            self._prep_jit = (jax.jit(prep_pure), prep_consts)
            self._chunk_jit = (jax.jit(chunk_pure), chunk_consts)
            if guard_k > 0:
                guard_pure, guard_consts = explicit_closure(
                    _make_chunk_prog("exact"),
                    _sds(self.params),
                    *(prep_sds[:1] + prep_sds[2:]),
                    jax.ShapeDtypeStruct(
                        (guard_k, int(x_pad.shape[1])), x_pad.dtype
                    ),
                )
                self._love_guard_jit = (jax.jit(guard_pure), guard_consts)
            else:
                self._love_guard_jit = None
        prep_fn, prep_consts = self._prep_jit
        Kw_alpha, sigma2, S, Tchol = prep_fn(prep_consts, self.params)
        chunk_fn, chunk_consts = self._chunk_jit
        means, vars_ = [], []
        for i in range(0, n_pad, chunk):
            mc, vc = chunk_fn(
                chunk_consts, self.params, Kw_alpha, S, Tchol, x_pad[i : i + chunk]
            )
            # Fetch per chunk: never let the async queue grow past a chunk.
            means.append(np.asarray(mc))
            vars_.append(np.asarray(vc))
        mean = np.concatenate(means)[:n_star]
        var = np.concatenate(vars_)[:n_star]
        if guard_k > 0 and self._love_guard_jit is not None:
            import warnings

            guard_fn, guard_consts = self._love_guard_jit
            _, v_exact = guard_fn(
                guard_consts, self.params, Kw_alpha, S, Tchol, x_new[:guard_k]
            )
            v_exact = np.asarray(v_exact)
            # Denominator floor at 1% of the sample's largest variance (round-4
            # review): a denormal-tiny exact variance must not turn a
            # negligible absolute deviation into an astronomic ratio — errors
            # are judged relative to max(point variance, 1% of the local
            # variance scale).
            vmax = float(max(np.max(v_exact), np.max(var[:guard_k]), 0.0))
            floor = max(1e-2 * vmax, float(np.finfo(v_exact.dtype).tiny))
            scale = np.maximum(np.abs(v_exact), floor)
            rel = float(np.max(np.abs(var[:guard_k] - v_exact) / scale))
            if rel > love_tol:
                msg = (
                    f"LOVE (variance='lanczos', var_rank={var_rank}) variance "
                    f"deviates from the exact route by up to {rel:.1%} on "
                    f"{guard_k} sampled test points (tolerance {love_tol:.0%})"
                )
                if love_on_fail == "raise":
                    raise RuntimeError(
                        msg + " — use variance='exact' or raise var_rank."
                    )
                if love_on_fail == "exact":
                    warnings.warn(
                        msg + " — auto-upgrading to the exact variance route "
                        "(love_on_fail='exact').",
                        stacklevel=2,
                    )
                    # Recompute via the exact route (guard-free there, so no
                    # recursion); the mean is identical between routes but
                    # comes for free with the chunk program.
                    return self.predict(
                        x_new, compute_var=compute_var,
                        include_noise=include_noise, chunk=0,
                        variance="exact",
                    )
                warnings.warn(
                    msg + " — use variance='exact' or raise var_rank.",
                    stacklevel=2,
                )
        if not compute_var:
            return mean
        if include_noise:
            var = var + float(sigma2)
        return mean, var
