"""Conjugate gradients as a `lax.while_loop` pipeline — no host round-trips.

JAX re-design of the reference's ``linalg.cg`` (reference:
``gp_grief/linalg.py`` — SURVEY.md §2 #7), which wraps
``scipy.sparse.linalg.cg`` around a ``LinearOperator``.  Here the operator is a
matvec closure and the whole iteration is one jitted ``lax.while_loop`` with a
tolerance-masked convergence test, so CG runs entirely on-device and
``jax.vmap``/``shard_map`` compose through it.  Batched right-hand sides are
solved simultaneously with **per-column** step sizes (a block of independent CG
recurrences sharing each matvec).

Gradients: the solve is wrapped in ``lax.custom_linear_solve(symmetric=True)``,
so the adjoint of ``x = A⁻¹ b`` is another CG solve with the same operator and
gradients flow to *both* ``b`` and any parameters captured inside the matvec
closure (GPyTorch BBMM pattern, PAPERS.md) — the loop is never unrolled.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["cg_solve", "cg_solve_refined", "cg_solve_segmented",
           "cg_solve_refined_segmented", "CGInfo"]


class CGInfo(NamedTuple):
    """Solver instrumentation — the reference's ``solver_counter`` equivalent
    (SURVEY.md §2 #9), returned as data instead of printed."""

    iterations: jax.Array  # scalar int32: iterations executed
    residual_norm: jax.Array  # (B,) final residual 2-norms


def _reducers(layout: str, axis_name: Optional[str]):
    """Per-system reduction + broadcast helpers for the two state layouts.

    ``layout="col"``: state is ``(m, B)`` — systems are columns (classic).
    ``layout="bm"``: state is ``(B, m)`` — systems are ROWS, the long solve
    axis contiguous in memory, so each system's reductions and axpys stream
    unit-stride.  Every solver path of the models uses it.
    """
    red_axis = 0 if layout == "col" else 1

    def colsum(t):
        s = jnp.sum(t, axis=red_axis)
        return lax.psum(s, axis_name) if axis_name is not None else s

    def colnorm(t):
        return jnp.sqrt(colsum(t * t))

    def bc(a):  # broadcast a (B,) per-system scalar against the state
        return a[None, :] if red_axis == 0 else a[:, None]

    return colsum, colnorm, bc


def _cg_raw(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    tol: float,
    max_iters: int,
    M_inv: Optional[Callable[[jax.Array], jax.Array]],
    axis_name: Optional[str] = None,
    layout: str = "col",
):
    """Preconditioned CG on a batched rhs ``b`` of shape ``(m, B)``
    (``layout="col"``) or ``(B, m)`` (``layout="bm"`` — see :func:`_reducers`).

    With ``axis_name`` set (inside ``shard_map``), rows of the system are
    sharded over that mesh axis and every inner product is ``psum``-reduced —
    CG across devices with no host round-trips (SURVEY.md §5 long-axis plan).
    """

    _colsum, _colnorm, _bc = _reducers(layout, axis_name)

    bnorm = _colnorm(b)  # (B,)
    # Clamp the relative tolerance at ~20·eps of the working dtype: f64-grade
    # defaults (1e-10) can never be met in f32, which would otherwise spin
    # every solve to max_iters after stagnating near 1e-6.
    eff_tol = max(float(tol), 20.0 * float(jnp.finfo(b.dtype).eps))
    stop = eff_tol * jnp.maximum(bnorm, jnp.finfo(b.dtype).tiny)

    precond = M_inv if M_inv is not None else (lambda r: r)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = _colsum(r0 * z0)  # (B,)
    dead0 = jnp.zeros(rz0.shape, bool)

    def cond(state):
        _, r, _, _, k, _, dead = state
        rn = _colnorm(r)
        return jnp.logical_and(k < max_iters, jnp.any((rn > stop) & ~dead))

    step = _make_pcg_step(matvec, precond, _colsum, _bc)

    def body(state):
        x, r, z, p, k, rz, dead = state
        x, r, z, p, rz, dead = step(x, r, z, p, rz, dead)
        return x, r, z, p, k + 1, rz, dead

    x, r, _, _, k, _, _ = lax.while_loop(
        cond, body, (x0, r0, z0, p0, 0, rz0, dead0)
    )
    return x, CGInfo(iterations=k, residual_norm=_colnorm(r))


def _make_pcg_step(matvec, precond, _colsum, _bc):
    """One preconditioned-CG iteration on state ``(x, r, z, p, rz, dead)`` —
    shared by the ``while_loop`` solver (:func:`_cg_raw`) and the
    host-segmented solver (:func:`cg_solve_segmented`)."""

    def step(x, r, z, p, rz, dead):
        Ap = matvec(p)
        pAp = _colsum(p * Ap)
        # Breakdown guard: a column whose curvature pAp is non-positive
        # (exact breakdown, or PD lost to f32 rounding on κ ≳ 1/eps
        # operators — stepping on it walks AWAY from the solution and
        # overflows to NaN within tens of iterations), whose preconditioned
        # product rz = rᵀM⁻¹r is non-positive (M⁻¹ lost SPD to rounding —
        # rz also hits 0 exactly when a column fully converges, where
        # freezing is the correct act), or whose recurrence went non-finite
        # is frozen PERMANENTLY at its current iterate; live columns keep
        # taking (benign) steps until every live column converges.
        ok = (pAp > 0) & (rz > 0) & jnp.isfinite(pAp) & jnp.isfinite(rz) & ~dead
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + _bc(alpha) * p
        r = r - _bc(alpha) * Ap
        z = precond(r)
        rz_new = _colsum(r * z)
        dead = dead | ~ok | ~jnp.isfinite(rz_new)
        beta = jnp.where(
            dead | (rz == 0), 0.0, rz_new / jnp.where(rz == 0, 1.0, rz)
        )
        p = z + _bc(beta) * p
        return x, r, z, p, rz_new, dead

    return step


def _segment_scan_mixed(matvec, state, segment_iters, _colsum, _bc, state_dtype):
    """Run ``segment_iters`` unpreconditioned-CG iterations on a 6-tuple
    ``(x, r, z, p, rz, dead)`` state, carrying ``r``/``p`` — and handing the
    matvec its input — in ``state_dtype`` INSIDE the scan (the
    :func:`_cg_fixed` mixed16 body).  The state enters and leaves in its
    original dtype with ``z`` kept ``== r``, so callers segmenting a solve
    across host dispatches (:meth:`GPSKIRegression._build_step_programs`)
    swap this in for the f32 segment scan without changing the state
    signature.  The stagnation floor rises to ~3.6e-3 relative on the
    whitened 1M/32⁴ lattice dual."""
    x, r, z, p, rz, dead = state
    wd = x.dtype
    sd = jnp.dtype(state_dtype)
    _st = lambda a: a.astype(sd)  # noqa: E731

    def body(s, _):
        x, r, p, rz, dead = s
        Ap = matvec(p)
        p32 = p.astype(wd)
        Ap32 = Ap.astype(wd)
        pAp = _colsum(p32 * Ap32)
        # Same permanent breakdown freeze as :func:`_cg_raw` — see there.
        ok = (pAp > 0) & (rz > 0) & jnp.isfinite(pAp) & jnp.isfinite(rz) & ~dead
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + _bc(alpha) * p32
        r32 = r.astype(wd) - _bc(alpha) * Ap32
        rz_new = _colsum(r32 * r32)
        dead = dead | ~ok | ~jnp.isfinite(rz_new)
        beta = jnp.where(
            dead | (rz == 0), 0.0, rz_new / jnp.where(rz == 0, 1.0, rz)
        )
        p_new = _st(r32 + _bc(beta) * p32)
        return (x, _st(r32), p_new, rz_new, dead), None

    (x, r_s, p_s, rz, dead), _ = lax.scan(
        body, (x, _st(r), _st(p), rz, dead), None, length=segment_iters
    )
    r = r_s.astype(wd)
    return (x, r, r, p_s.astype(wd), rz, dead)


def _cg_fixed(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    num_iters: int,
    M_inv: Optional[Callable[[jax.Array], jax.Array]],
    axis_name: Optional[str] = None,
    layout: str = "col",
    state_dtype=None,
):
    """Fixed-iteration CG as a ``lax.scan`` — no convergence test, so each
    iteration skips the residual-norm pass and the loop carries no branch.
    Use when the iteration count is known/budgeted (batched solves, profiling,
    sharded contexts where the ``cond`` reduction costs a collective).

    ``state_dtype`` (e.g. ``jnp.bfloat16``) stores the carried ``r``/``p``
    vectors — and hands the matvec its input — in that dtype, halving the
    loop's state memory traffic at lattice scale; the ``x`` accumulator, all
    reductions, and the axpy arithmetic stay in ``b.dtype`` (casts fuse into
    the updates).  The stagnation floor rises to ~``state_dtype`` epsilon, so
    this is for *inner* solves whose accuracy an outer refinement loop
    restores (:func:`cg_solve_refined`)."""

    _colsum, _, _bc = _reducers(layout, axis_name)

    wd = b.dtype
    sd = None if state_dtype is None or jnp.dtype(state_dtype) == wd else jnp.dtype(state_dtype)
    _st = (lambda a: a.astype(sd)) if sd is not None else (lambda a: a)
    has_pre = M_inv is not None

    if x0 is None:  # known-zero start: r0 = b, skip one full matvec
        x0 = jnp.zeros(b.shape, wd)
        r0 = b
    else:
        # astype(wd): a matvec whose closure promotes (e.g. an x64 sigma2
        # over f32 data) must not leak a wider dtype into the scan carry.
        r0 = (b - matvec(x0)).astype(wd)
    z0 = (M_inv(r0) if has_pre else r0).astype(wd)
    rz0 = _colsum(r0 * z0)
    dead0 = jnp.zeros(rz0.shape, bool)

    def body(state, _):
        x, r, z, p, rz, dead = state
        Ap = matvec(p)
        p32 = p.astype(wd)
        Ap32 = Ap.astype(wd)
        pAp = _colsum(p32 * Ap32)
        # Same non-positive-curvature / non-positive-rz / non-finite
        # permanent freeze as :func:`_cg_raw` — see the comment there.
        ok = (pAp > 0) & (rz > 0) & jnp.isfinite(pAp) & jnp.isfinite(rz) & ~dead
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + _bc(alpha) * p32
        r32 = r.astype(wd) - _bc(alpha) * Ap32
        z32 = M_inv(r32) if has_pre else r32
        rz_new = _colsum(r32 * z32)
        dead = dead | ~ok | ~jnp.isfinite(rz_new)
        beta = jnp.where(
            dead | (rz == 0), 0.0, rz_new / jnp.where(rz == 0, 1.0, rz)
        )
        p_new = _st(z32 + _bc(beta) * p32)
        z_new = _st(z32) if has_pre else None
        return (x, _st(r32), z_new, p_new, rz_new, dead), None

    (x, r, _, _, _, _), _ = lax.scan(
        body,
        (x0, _st(r0), _st(z0) if has_pre else None, _st(z0), rz0, dead0),
        None,
        length=num_iters,
    )
    r32 = r.astype(wd)
    return x, CGInfo(
        iterations=jnp.asarray(num_iters, jnp.int32),
        residual_norm=jnp.sqrt(_colsum(r32 * r32)),
    )


def cg_solve(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    *,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-10,
    max_iters: int = 1000,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    return_info: bool = False,
    axis_name: Optional[str] = None,
    fixed_iters: Optional[int] = None,
    layout: str = "col",
    implicit_diff: bool = True,
):
    """Solve ``A x = b`` for symmetric positive-definite ``A`` given only a matvec.

    Args:
      matvec: closure computing ``A @ v`` for ``v`` of shape ``(m, B)``
        (must also accept ``(m, 1)``; must be linear in ``v``).  With
        ``layout="bm"`` the contract flips: ``v`` is ``(B, m)`` — each ROW an
        independent system.
      b: ``(m,)`` or ``(m, B)`` right-hand side(s); ``(B, m)`` when
        ``layout="bm"``.
      x0: optional initial guess (zeros by default; only used on the primal
        solve — the adjoint solve starts from zeros).
      tol: relative residual tolerance per column.
      max_iters: static iteration cap (the `while_loop` bound).
      M_inv: optional preconditioner closure ``v ↦ M⁻¹ v`` (same layout as the
        matvec); affects convergence only, so it is excluded from
        differentiation.
      return_info: also return :class:`CGInfo` (iterations, residuals).
        The info path is not differentiable (use the default path under grad).
      axis_name: mesh axis the system rows are sharded over (``shard_map``
        context); inner products become ``psum`` collectives.
      fixed_iters: run exactly this many iterations as a branch-free
        ``lax.scan`` instead of the tolerance-tested ``while_loop`` (skips the
        per-iteration residual-norm pass; right for budgeted/profiled solves).
      layout: ``"col"`` (state ``(m, B)``) or ``"bm"`` (state ``(B, m)`` —
        keeps the long solve axis contiguous; see :func:`_reducers`).
      implicit_diff: wrap the solve in ``lax.custom_linear_solve`` so
        ``jax.grad`` through the solution uses the implicit adjoint solve.
        Pass ``False`` for value-only solves (e.g. BBMM-style NLML paths
        that ``stop_gradient`` the solution and differentiate through
        surrogates): it skips a second trace of the matvec.
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    squeeze = b.ndim == 1
    if squeeze:
        bb = b[:, None] if layout == "col" else b[None, :]
    else:
        bb = b
    if x0 is None:
        x0b = jnp.zeros_like(bb)
    else:
        x0b = (x0[:, None] if layout == "col" else x0[None, :]) if squeeze else x0

    def _unsqueeze(x):
        if not squeeze:
            return x
        return x[:, 0] if layout == "col" else x[0]

    def _raw(mv, rhs, start):
        if fixed_iters is not None:
            return _cg_fixed(mv, rhs, start, fixed_iters, M_inv, axis_name, layout)
        return _cg_raw(mv, rhs, start, tol, max_iters, M_inv, axis_name, layout)

    if return_info:
        x, info = _raw(matvec, bb, x0b)
        return _unsqueeze(x), info

    if not implicit_diff:
        x, _ = _raw(matvec, bb, x0b)
        return _unsqueeze(x)

    def _solve(mv, rhs):
        # x0 only applies to the primal solve; custom_linear_solve re-invokes
        # this for the adjoint where the rhs differs, so a zero start is used
        # there via the same closure (x0b is shaped like bb in both cases).
        x, _ = _raw(mv, rhs, jnp.zeros_like(rhs))
        return x

    if x0 is not None:
        # Warm start: solve for the residual correction so the wrapped solve
        # still maps rhs ↦ A⁻¹ rhs (a linear map, as custom_linear_solve needs).
        x = x0b + lax.custom_linear_solve(
            matvec, bb - matvec(x0b), solve=_solve, symmetric=True
        )
    else:
        x = lax.custom_linear_solve(matvec, bb, solve=_solve, symmetric=True)
    return _unsqueeze(x)


def cg_solve_segmented(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    *,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-6,
    segment_iters: int = 50,
    max_segments: int = 20,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    layout: str = "col",
    return_info: bool = False,
    verbose: bool = False,
):
    """Host-segmented preconditioned CG — the same recurrence as
    :func:`cg_solve`, executed as a host loop of fixed-length jitted segment
    programs with the solver state resident on device between dispatches.

    Why this exists: it bounds how long any one device program runs.
    Segmenting keeps every program at ``segment_iters`` iterations while the
    convergence test moves to the host: one ``(B,)`` residual fetch per
    segment is the only host↔device sync (state arrays never leave device
    memory).  Whether the GPU needs the bound is open (ROADMAP 3c).  The result is
    bit-identical to ``cg_solve(..., max_iters=segment_iters*max_segments)``
    up to the iteration granularity of the stopping test (it can run at most
    ``segment_iters − 1`` extra iterations past the while_loop's exit point;
    converged/broken-down columns are frozen by the same guard either way).

    Value-only: NOT differentiable (no ``custom_linear_solve`` wrapper) —
    use inside stop-gradient NLML paths (BBMM surrogates) or for prediction.

    Each call re-jits its segment program (the matvec closure is fresh);
    callers looping over many solves should hold ``b`` batched in one call.
    Arrays the closures capture (``b``, plan tables, preconditioner factors)
    are hoisted into explicit jit arguments
    (:func:`gp_grief_jax.utils.closure.explicit_closure`), so multi-GB
    operands are passed as device buffers, never embedded in the program.

    Returns ``x`` (and :class:`CGInfo` when ``return_info``).
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    import numpy as np

    from gp_grief_jax.utils.closure import explicit_closure

    squeeze = b.ndim == 1
    if squeeze:
        bb = b[:, None] if layout == "col" else b[None, :]
    else:
        bb = b
    if x0 is None:
        x0b = jnp.zeros_like(bb)
    else:
        x0b = (x0[:, None] if layout == "col" else x0[None, :]) if squeeze else x0

    _colsum, _colnorm, _bc = _reducers(layout, None)
    precond = M_inv if M_inv is not None else (lambda r: r)
    step = _make_pcg_step(matvec, precond, _colsum, _bc)

    def init():
        r0 = bb - matvec(x0b)
        z0 = precond(r0)
        rz0 = _colsum(r0 * z0)
        dead0 = jnp.zeros(rz0.shape, bool)
        return (x0b, r0, z0, z0, rz0, dead0), _colnorm(bb), _colnorm(r0)

    def segment_fn(state):
        def body(s, _):
            return step(*s), None

        state, _ = lax.scan(body, state, None, length=segment_iters)
        return state, _colnorm(state[1]), state[5]

    init_pure, init_consts = explicit_closure(init)
    state, bnorm, rnorm = jax.jit(init_pure)(init_consts)
    state_sds = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state
    )
    seg_pure, seg_consts = explicit_closure(segment_fn, state_sds)
    segment = jax.jit(seg_pure)
    eff_tol = max(float(tol), 20.0 * float(jnp.finfo(bb.dtype).eps))
    stop = eff_tol * np.maximum(np.asarray(bnorm), float(jnp.finfo(bb.dtype).tiny))
    rnorm_h = np.asarray(rnorm)
    dead_h = np.zeros(rnorm_h.shape, bool)
    iters = 0
    for s in range(max_segments):
        if not np.any((rnorm_h > stop) & ~dead_h):
            break
        state, rnorm, dead = segment(seg_consts, state)
        # The per-segment fetch is the host-side convergence test; it also
        # bounds the async queue at one segment.
        rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
        iters += segment_iters
        if verbose:
            print(
                f"[cg_segmented] segment {s + 1}: iters={iters} "
                f"max_rel_resid={float(np.max(rnorm_h / np.maximum(np.asarray(bnorm), 1e-30))):.3e}"
            )
    x = state[0]

    def _unsqueeze(t):
        if not squeeze:
            return t
        return t[:, 0] if layout == "col" else t[0]

    if return_info:
        return _unsqueeze(x), CGInfo(
            iterations=jnp.asarray(iters, jnp.int32), residual_norm=rnorm
        )
    return _unsqueeze(x)


def cg_solve_refined(
    matvec_fast: Callable[[jax.Array], jax.Array],
    matvec_exact: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    *,
    tol: float = 1e-6,
    inner_iters: int = 50,
    max_restarts: int = 20,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    axis_name: Optional[str] = None,
    return_info: bool = False,
    layout: str = "col",
    state_dtype=None,
    implicit_diff: bool = True,
):
    """Mixed-precision CG via iterative refinement (Carson–Higham pattern).

    Outer loop: ``r ← b − A_exact x`` with the *exact* (high-precision)
    matvec; inner loop: ``inner_iters`` branch-free CG iterations on the
    correction system ``A d = r`` using the *fast* (low-precision, e.g. TF32
    or bf16) matvec; ``x ← x + d``.  The final accuracy is governed by the
    exact residual refreshes, not by the fast matvec — so the hot loop runs
    at the fast matvec's rate while the solution converges to ``tol`` in the
    exact operator's arithmetic.

    No reference counterpart (the reference's CG is SciPy double precision —
    SURVEY.md §2 #7): low-precision tensor-core products are several times
    faster than exact f32, and refinement keeps the solution accuracy.

    Returns ``x`` (and ``CGInfo`` with total inner iterations + final TRUE
    residual norms when ``return_info``).

    Differentiable like :func:`cg_solve`: the solve is wrapped in
    ``lax.custom_linear_solve(symmetric=True)`` with ``matvec_exact`` as the
    defining operator, so the adjoint is another refined solve and gradients
    flow to ``b`` and to parameters captured in ``matvec_exact``'s closure
    (parameters captured only by ``matvec_fast`` affect convergence, not the
    solution, and are correctly excluded).  The ``return_info`` path is not
    differentiable (as with :func:`cg_solve`).

    ``layout="bm"`` flips the state/matvec contract to ``(B, m)`` rows — see
    :func:`cg_solve`.

    ``implicit_diff=False`` skips the ``custom_linear_solve`` wrapper (value
    path, like :func:`cg_solve`'s flag).  REQUIRED when ``matvec_exact`` is a
    matrix-free scan-rebuilt operator (:func:`gp_grief_jax.models.
    gp_regression.make_gram_matvec`) inside a differentiated program:
    ``custom_linear_solve`` partial-evaluates the matvec into a linear
    function of the vector, which hoists every vector-independent
    intermediate — the per-block Gram slabs — into ONE stacked
    ``(nb, n, chunk)`` constant carried through the solve: the O(n²) buffer
    the operator exists to avoid (measured: 64 GB compile-time allocation at
    n=2¹⁷/chunk=2048, round-5).  Callers that stop-gradient the solution and
    differentiate via surrogates (the BBMM NLML losses) lose nothing.

    ``state_dtype`` (e.g. ``jnp.bfloat16``) stores the INNER loop's carried
    vectors — and hands ``matvec_fast`` its input — in that dtype (see
    :func:`_cg_fixed`): the inner state traffic halves and a slab-dispatched
    ``matvec_fast`` reads a bf16 vector natively.  The outer exact residual
    refreshes still govern final accuracy; expect a few more restarts on
    hard systems.  ``matvec_fast`` must accept a ``state_dtype`` input
    (:func:`~gp_grief_jax.ops.kron_fast.kron_matvec_fast` does).
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    squeeze = b.ndim == 1
    if squeeze:
        bb = b[:, None] if layout == "col" else b[None, :]
    else:
        bb = b

    def _unsqueeze(x):
        if not squeeze:
            return x
        return x[:, 0] if layout == "col" else x[0]

    _, _colnorm, _bc = _reducers(layout, axis_name)

    def _refined_raw(mv_exact, rhs):
        bnorm = _colnorm(rhs)
        stop = tol * jnp.maximum(bnorm, jnp.finfo(rhs.dtype).tiny)

        def cond(state):
            _, _, rnorm, rnorm_best, outer = state
            # Divergence brake: mixed-precision refinement only converges when
            # the low-precision inner solve makes progress (Carson–Higham);
            # on severely ill-conditioned operators (κ ≳ 1/ε_fast) the
            # corrections can GROW the residual without bound and the
            # unguarded loop overflows to NaN (measured: κ~1e9 Kron lattice).
            # Temporary growth is normal for restarted refinement, so steps
            # are not rejected — but once the current residual exceeds 100×
            # the best seen, further restarts are hopeless; stop and return
            # the best iterate (info reports its true residual honestly).
            diverged = jnp.all(rnorm > 100.0 * jnp.maximum(rnorm_best, stop))
            return jnp.logical_and(
                jnp.logical_and(outer < max_restarts, jnp.any(rnorm_best > stop)),
                jnp.logical_not(diverged),
            )

        def body(state):
            x, x_best, rnorm, rnorm_best, outer = state
            r = rhs - mv_exact(x)
            d, _ = _cg_fixed(
                matvec_fast, r, jnp.zeros_like(r), inner_iters, M_inv, axis_name,
                layout, state_dtype,
            )
            x = x + d
            rnorm = _colnorm(rhs - mv_exact(x))
            # NaN-poisoning guard: the inner low-precision CG can overflow
            # its iterate to inf one step before its own freeze triggers
            # (alpha = rz/denormal-pAp), making this rnorm NaN.  Unsanitized,
            # `NaN > stop` is False — the loop exits looking "converged",
            # the divergence brake never trips, and the FALLBACK is skipped:
            # measured x = 0 returned as the solution (2.7×-wrong NLML at
            # the m=33.5M / rank-512 config).  Map
            # non-finite residuals to +inf so every comparison stays honest.
            rnorm = jnp.where(jnp.isfinite(rnorm), rnorm, jnp.inf)
            better = rnorm < rnorm_best
            x_best = jnp.where(_bc(better), x, x_best)
            rnorm_best = jnp.minimum(rnorm, rnorm_best)
            return x, x_best, rnorm, rnorm_best, outer + 1

        x0 = jnp.zeros_like(rhs)
        _, x_best, _, rnorm_best, outer = lax.while_loop(
            cond, body, (x0, x0, bnorm, bnorm, jnp.asarray(0, jnp.int32))
        )

        # Graceful degradation: if refinement exits with ANY column above
        # tolerance, finish with plain exact-matvec CG warm-started from the
        # best iterate — so "mixed" is never *worse* than "exact" in result,
        # only in (failure-case) time.  The earlier laxer bar ("fall back
        # only if refinement couldn't even cut the residual 10×") returned
        # partially-converged iterates whose rel residual ~0.05 passed as
        # solutions — a 2.7×-wrong NLML at the m=33.5M / rank-512 config.
        # A near-converged warm start costs
        # the exact solver only a few iterations, so tightening is cheap.
        failed = jnp.any(rnorm_best > stop)

        def _fallback(xb):
            x, info = _cg_raw(
                mv_exact, rhs, xb, tol, inner_iters * max_restarts, M_inv,
                axis_name, layout,
            )
            # f32 CG can itself wander post-stagnation on κ ≳ 1e6 systems —
            # keep whichever iterate has the smaller true residual.
            better = info.residual_norm < rnorm_best
            return (
                jnp.where(_bc(better), x, xb),
                jnp.minimum(info.residual_norm, rnorm_best),
            )

        def _keep(xb):
            return xb, rnorm_best

        x_best, rnorm_best = lax.cond(failed, _fallback, _keep, x_best)
        return x_best, rnorm_best, outer

    if return_info:
        x, rnorm, outer = _refined_raw(matvec_exact, bb)
        info = CGInfo(iterations=outer * inner_iters, residual_norm=rnorm)
        return _unsqueeze(x), info

    if not implicit_diff:
        return _unsqueeze(_refined_raw(matvec_exact, bb)[0])

    x = lax.custom_linear_solve(
        matvec_exact, bb, solve=lambda mv, rhs: _refined_raw(mv, rhs)[0], symmetric=True
    )
    return _unsqueeze(x)


def cg_solve_refined_segmented(
    matvec_fast: Callable[[jax.Array], jax.Array],
    matvec_exact: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    *,
    tol: float = 1e-6,
    inner_iters: int = 25,
    max_restarts: int = 20,
    M_inv: Optional[Callable[[jax.Array], jax.Array]] = None,
    layout: str = "col",
    state_dtype=None,
    return_info: bool = False,
    verbose: bool = False,
):
    """Host-segmented mixed-precision CG (iterative refinement) — the
    :func:`cg_solve_refined` recurrence executed as a HOST loop of bounded
    device programs, for operators whose single apply costs seconds (the
    matrix-free Gram matvec at n ≥ 500k, where one ``inner_iters`` restart
    is already a long program).

    Per restart, TWO programs run: (1) fold in the previous correction and
    refresh the TRUE residual with ``matvec_exact`` (one exact apply); (2)
    ``inner_iters`` branch-free CG iterations on the correction system with
    ``matvec_fast`` (e.g. the ``precision="default"`` Gram slab
    rebuild — :func:`gp_grief_jax.models.gp_regression.make_gram_matvec`).
    State stays device-resident; one ``(B,)`` residual-norm fetch per
    restart is the only sync.  Best-iterate tracking + the 100× divergence
    brake of :func:`cg_solve_refined` run host-side; on failure the result
    gracefully degrades to exact-matvec segmented CG warm-started from the
    best iterate (mixed is never WORSE than exact in result — r5 §12 rule).

    Value-only: NOT differentiable (pair with BBMM gradient surrogates).
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    import numpy as np

    from gp_grief_jax.utils.closure import explicit_closure

    squeeze = b.ndim == 1
    if squeeze:
        bb = b[:, None] if layout == "col" else b[None, :]
    else:
        bb = b

    def _unsqueeze(t):
        if not squeeze:
            return t
        return t[:, 0] if layout == "col" else t[0]

    _, _colnorm, _bc = _reducers(layout, None)
    sds = lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a))  # noqa: E731

    # Program 1: x ← x + d; r ← bb − A_exact x; rnorm.  (d=0 on entry.)
    def refresh(x, d):
        x2 = x + d
        r = bb - matvec_exact(x2)
        rn = _colnorm(r)
        return x2, r, jnp.where(jnp.isfinite(rn), rn, jnp.inf)

    # Program 2: inner fast CG on the correction system.
    def inner(r):
        d, _ = _cg_fixed(
            matvec_fast, r, jnp.zeros_like(r), inner_iters, M_inv, None,
            layout, state_dtype,
        )
        return d

    zero = jnp.zeros_like(bb)
    ref_pure, ref_consts = explicit_closure(refresh, sds(zero), sds(zero))
    inner_pure, inner_consts = explicit_closure(inner, sds(zero))
    ref_prog = jax.jit(ref_pure)
    inner_prog = jax.jit(inner_pure)

    x, r, rnorm = ref_prog(ref_consts, zero, zero)
    bnorm = np.asarray(_colnorm(bb))
    stop = float(tol) * np.maximum(bnorm, float(jnp.finfo(bb.dtype).tiny))
    rnorm_h = np.asarray(rnorm)
    x_best, rnorm_best = x, rnorm_h
    outer = 0
    while outer < max_restarts and np.any(rnorm_best > stop):
        if np.all(rnorm_h > 100.0 * np.maximum(rnorm_best, stop)):
            break  # divergence brake (see cg_solve_refined)
        d = inner_prog(inner_consts, r)
        x, r, rnorm = ref_prog(ref_consts, x, d)
        rnorm_h = np.asarray(rnorm)
        better = rnorm_h < rnorm_best
        if np.any(better):
            # Keep the per-column best on device (one tiny select program is
            # cheaper than shipping (B, n) iterates to host).
            x_best = jnp.where(_bc(jnp.asarray(better)), x, x_best)
            rnorm_best = np.minimum(rnorm_h, rnorm_best)
        outer += 1
        if verbose:
            rel = float(np.max(rnorm_h / np.maximum(bnorm, 1e-30)))
            print(
                f"[cg_refined_segmented] restart {outer}: "
                f"max_rel_resid={rel:.3e}", flush=True,
            )

    if np.any(rnorm_best > stop):
        # Graceful degradation: exact-matvec segmented CG warm-started from
        # the best iterate (see cg_solve_refined's fallback rationale).
        x_fb, info = cg_solve_segmented(
            matvec_exact, bb, x0=x_best, tol=tol,
            segment_iters=inner_iters, max_segments=max_restarts,
            M_inv=M_inv, layout=layout, return_info=True, verbose=verbose,
        )
        rn_fb = np.asarray(info.residual_norm)
        better = rn_fb < rnorm_best
        x_best = jnp.where(_bc(jnp.asarray(better)), x_fb, x_best)
        rnorm_best = np.minimum(rn_fb, rnorm_best)

    if return_info:
        return _unsqueeze(x_best), CGInfo(
            iterations=jnp.asarray(outer * inner_iters, jnp.int32),
            residual_norm=jnp.asarray(rnorm_best),
        )
    return _unsqueeze(x_best)
