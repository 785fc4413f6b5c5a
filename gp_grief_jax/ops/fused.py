"""Fused CG + Lanczos(SLQ) iterations sharing each operator application.

The iterative NLML of the structured models needs BOTH a CG solve of
``A x = b`` (the quadratic form) and ``R`` Lanczos recurrences on the same
operator (the SLQ log-det probes) — the reference runs them as separate
solver calls (SURVEY.md §2 #7/#8, `gp_grief/linalg.py` cg/lanczos).  The
hot operators are *batched applies whose cost is nearly flat in the batch
size* over the relevant range: the matrix-free Gram matvec rebuilds the
same covariance slabs for any batch, and the Kron-lattice matvec is
bandwidth-bound on the *lattice* bytes, not the batch.  Running CG's
``(1, m)`` iterations and the SLQ probes' ``(R, m)`` recurrences in
SEPARATE passes therefore pays for the operator twice.

This module advances both through ONE ``(1+R, m)`` application per
iteration: row 0 carries the CG search direction, rows 1..R the Lanczos
probe block.  The arithmetic is exactly :func:`gp_grief_jax.ops.cg.
_make_pcg_step` (identity preconditioner) and
:func:`gp_grief_jax.ops.lanczos.lanczos_batched`'s step, so the fused
estimator is the same family as the separate-pass one (identical probe
draws → identical tridiagonals up to batched-apply rounding).

Batch-major (``bm``) layout only — states are ``(B, m)`` rows with the
long axis contiguous (see ``ops.cg._reducers``).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from gp_grief_jax.ops.cg import _reducers
from gp_grief_jax.ops.lanczos import _slq_quadrature

__all__ = [
    "make_fused_cg_lanczos_step",
    "fused_cg_slq_segment",
    "fused_cg_slq_segmented",
]


def make_fused_cg_lanczos_step(
    op: Callable[[jax.Array], jax.Array],
    _colsum,
    _colnorm,
    _bc,
    freeze_rz=None,
):
    """One fused iteration: CG state (``Bc`` rows) + ``R`` Lanczos
    recurrences through a single ``op`` application on ``(Bc+R, m)``.

    ``cg_state``: ``(x, r, z, p, rz, dead)`` as in ``ops.cg``;
    ``lz_carry``: ``(q, q_prev, beta_prev, alive)`` as in
    ``ops.lanczos.lanczos_batched``.  Returns the advanced states plus the
    per-iteration Lanczos outputs ``(alpha_out, beta_out, alive)`` for the
    SLQ quadrature.  The preconditioner is the identity (both model
    segmented paths run in a whitened basis where that is exact).

    ``freeze_rz``: per-column CONVERGENCE freeze threshold on ``rz = rᵀr``
    (i.e. ``stop²`` for a residual-norm stop): the probe phase advances the
    CG state for as many iterations as the Lanczos recurrences run — with
    no stop of its own, post-convergence f32 CG can wander on κ ≳ 1e6
    systems (the ops.cg fallback lesson).  Converged columns freeze via the
    same ``dead`` mechanism as breakdowns, so extra fused iterations leave
    ``x`` untouched.  ``None`` keeps the pure recurrence.
    """

    def step(cg_state, lz_carry):
        x, r, z, p, rz, dead = cg_state
        q, q_prev, beta_prev, alive = lz_carry
        Bc = p.shape[0]
        AV = op(jnp.concatenate([p, q], axis=0))
        Ap, w = AV[:Bc], AV[Bc:]

        # -- CG update: same arithmetic/guards as ops.cg._make_pcg_step ----
        pAp = _colsum(p * Ap)
        ok = (pAp > 0) & (rz > 0) & jnp.isfinite(pAp) & jnp.isfinite(rz) & ~dead
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x = x + _bc(alpha) * p
        r = r - _bc(alpha) * Ap
        z = r  # identity preconditioner
        rz_new = _colsum(r * z)
        dead_new = dead | ~ok | ~jnp.isfinite(rz_new)
        if freeze_rz is not None:
            dead_new = dead_new | (rz_new <= freeze_rz)
        beta = jnp.where(
            dead_new | (rz == 0), 0.0, rz_new / jnp.where(rz == 0, 1.0, rz)
        )
        p = z + _bc(beta) * p
        cg_next = (x, r, z, p, rz_new, dead_new)

        # -- Lanczos update: same arithmetic as lanczos_batched.step -------
        dtype = q.dtype
        eps = jnp.finfo(dtype).eps
        alpha_i = _colsum(w * q)
        w = w - _bc(alpha_i) * q - _bc(beta_prev) * q_prev
        beta_i = _colnorm(w)
        scale = jnp.abs(alpha_i) + beta_prev + jnp.asarray(1.0, dtype)
        broke = beta_i <= 100 * eps * scale
        q_next = jnp.where(
            _bc(broke), jnp.zeros_like(w),
            w / _bc(jnp.where(beta_i == 0, 1.0, beta_i)),
        )
        alpha_out = jnp.where(alive, alpha_i, 0.0)
        beta_out = jnp.where(jnp.logical_and(alive, ~broke), beta_i, 0.0)
        alive_next = jnp.logical_and(alive, ~broke)
        lz_next = (q_next, q, beta_out, alive_next)
        return cg_next, lz_next, (alpha_out, beta_out, alive)

    return step


def fused_cg_slq_segment(
    op: Callable[[jax.Array], jax.Array],
    cg_state,
    Z: jax.Array,
    lanczos_iters: int,
    *,
    axis_name: Optional[str] = None,
    freeze_rz=None,
):
    """Advance a bm CG state by ``lanczos_iters`` iterations while running a
    full ``R``-probe Lanczos/SLQ pass on the same operator.

    ``Z``: ``(R, m)`` probe block (caller draws it — pass the SAME
    Rademacher draw the separate-pass SLQ would use and the estimator
    matches that family exactly).  Returns ``(cg_state, slq_mean)`` where
    ``slq_mean`` is this chunk's SLQ estimate of ``log|A|`` (mean over the
    ``R`` probes), i.e. exactly what ``ops.lanczos.slq_logdet`` returns for
    the chunk.  Jit-traceable; cost = ``lanczos_iters`` applies of a
    ``(Bc+R, m)`` block instead of ``lanczos_iters`` applies of ``(R, m)``
    PLUS ``lanczos_iters`` applies of ``(Bc, m)``.
    """
    _colsum, _colnorm, _bc = _reducers("bm", axis_name)
    dtype = Z.dtype
    R = Z.shape[0]
    k = int(lanczos_iters)
    q0 = Z / _bc(_colnorm(Z))
    lz0 = (
        q0,
        jnp.zeros_like(q0),
        jnp.zeros((R,), dtype),
        jnp.ones((R,), bool),
    )
    step = make_fused_cg_lanczos_step(
        op, _colsum, _colnorm, _bc, freeze_rz=freeze_rz
    )

    def body(carry, _):
        cgs, lzc = carry
        cgs, lzc, outs = step(cgs, lzc)
        return (cgs, lzc), outs

    (cg_state, _), (alphas, betas, alive_flags) = lax.scan(
        body, (cg_state, lz0), None, length=k
    )
    betas = betas[:-1]
    num_valid = jnp.sum(alive_flags.astype(jnp.int32), axis=0)
    znorm2 = jnp.sum(Z * Z, axis=1)
    if axis_name is not None:
        znorm2 = lax.psum(znorm2, axis_name)
    vals = jax.vmap(
        lambda a, b, nv, zn: zn * _slq_quadrature(a, b, nv, k),
        in_axes=(1, 1, 0, 0),
    )(alphas, betas, num_valid, znorm2)
    return cg_state, jnp.mean(vals)


def fused_cg_slq_segmented(
    op: Callable[[jax.Array], jax.Array],
    rhs: jax.Array,
    m: int,
    key: jax.Array,
    *,
    num_probes: int,
    lanczos_iters: int,
    probe_chunk: int = 8,
    iter_segment: Optional[int] = None,
    cg_tol: float = 1e-6,
    cg_iters: int = 400,
    cg_segment_iters: int = 50,
    verbose: bool = False,
) -> tuple[jax.Array, float, int]:
    """Host-segmented fused CG + SLQ driver (round-5).

    Advances a bm-layout CG solve of ``A x = rhs`` (``rhs``: ``(Bc, m)``
    rows, normally ``Bc=1``) through the probe phase's shared operator
    applications: each device program runs ``iter_segment`` (or all
    ``lanczos_iters``) fused steps — ONE ``(Bc+R, m)`` apply per iteration
    drives both the CG recurrence and ``R`` Lanczos probe recurrences
    (:func:`make_fused_cg_lanczos_step`).  The Lanczos carry stays
    device-resident between dispatches; only the tiny per-iteration α/β
    blocks come to host, where the Gauss quadrature runs in f64 (the
    :func:`gp_grief_jax.ops.lanczos.slq_logdet_segmented` pattern).  After
    the probes are exhausted, leftover plain-CG segments finish the solve
    to ``cg_tol``.

    Why: on operators whose apply cost is FLAT in the batch (the
    matrix-free Gram matvec rebuilds the same (chunk, n) cov slabs for any
    B; the structured lattice operators are bandwidth-bound on lattice
    bytes), running CG and SLQ as separate passes pays for the operator
    twice — the total Gram sweeps become ~max(CG, SLQ) instead of their
    sum.  ``iter_segment`` bounds each program for operators where one
    apply costs seconds.

    Probe draws: chunk ``c`` uses ``fold_in(key, c)`` — identical to
    :func:`slq_logdet_segmented`'s family.  Returns ``(x, slq_logdet_mean,
    cg_iterations)``.  The caller wraps ``op`` in ``safe_batch_op`` and
    whitens/offsets the log-det as needed.
    """
    import numpy as np

    from gp_grief_jax.ops.cg import _make_pcg_step
    from gp_grief_jax.ops.lanczos import (
        _chunk_quadrature_total,
        _probe_chunk_sizes,
    )
    from gp_grief_jax.utils.closure import explicit_closure

    if num_probes <= 0:
        raise ValueError("num_probes must be positive")
    dtype = rhs.dtype
    k = int(lanczos_iters)
    _colsum, _colnorm, _bc = _reducers("bm", None)

    sizes = _probe_chunk_sizes(num_probes, probe_chunk)
    seg = k if iter_segment is None else max(1, min(int(iter_segment), k))
    seg_lens = [seg] * (k // seg)
    if k % seg:
        seg_lens.append(k % seg)

    x0 = jnp.zeros_like(rhs)
    rz0 = _colsum(rhs * rhs)
    state = (x0, rhs, rhs, rhs, rz0, jnp.zeros(rz0.shape, bool))
    bnorm = np.asarray(_colnorm(rhs))

    sds = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), t
    )
    key_sds = jax.ShapeDtypeStruct(key.shape, key.dtype)

    # Probe-chunk init programs (draw Z, normalize, carry init) per R.
    init_progs = {}
    for r in sorted(set(sizes)):

        def init_fn(kk, rr=r):
            Z = jax.random.rademacher(kk, (rr, m), dtype=dtype)
            q0 = Z / _bc(_colnorm(Z))
            carry = (
                q0, jnp.zeros_like(q0), jnp.zeros((rr,), dtype),
                jnp.ones((rr,), bool),
            )
            return carry, _colsum(Z * Z)

        ip, ic = explicit_closure(init_fn, key_sds)
        init_progs[r] = (jax.jit(ip), ic)

    eff_tol = max(float(cg_tol), 20.0 * float(jnp.finfo(dtype).eps))
    stop = eff_tol * np.maximum(bnorm, float(jnp.finfo(dtype).tiny))

    # Fused segment programs per (R, seg_len): advance CG + Lanczos jointly.
    # freeze_rz = stop²: the probe phase runs as many CG iterations as the
    # Lanczos recurrences regardless of convergence — converged columns
    # freeze (dead-flag mechanism) so post-convergence f32 wander cannot
    # degrade the returned iterate (the ops.cg κ ≳ 1e6 lesson).
    fused_progs = {}
    step = make_fused_cg_lanczos_step(
        op, _colsum, _colnorm, _bc,
        freeze_rz=jnp.asarray(stop * stop, dtype),
    )
    for r in sorted(set(sizes)):
        ip, ic = init_progs[r]
        carry_sds = jax.eval_shape(ip, ic, key_sds)[0]
        for ln in sorted(set(seg_lens)):

            def seg_fn(st, lzc, _ln=ln):
                def body(carry, _):
                    cgs, lz = carry
                    cgs, lz, outs = step(cgs, lz)
                    return (cgs, lz), outs

                (st2, lz2), outs = lax.scan(
                    body, (st, lzc), None, length=_ln
                )
                return st2, lz2, outs, _colnorm(st2[1]), st2[5]

            sp, sc = explicit_closure(seg_fn, sds(state), carry_sds)
            fused_progs[(r, ln)] = (jax.jit(sp), sc)

    total = 0.0
    iters = 0
    rnorm_h, dead_h = bnorm, np.zeros(bnorm.shape, bool)
    for c, r in enumerate(sizes):
        ip, ic = init_progs[r]
        lz_carry, znorm2 = ip(ic, jax.random.fold_in(key, c))
        a_rows, b_rows, alive_rows = [], [], []
        for ln in seg_lens:
            sp, sc = fused_progs[(r, ln)]
            state, lz_carry, (a, b, al), rnorm, dead = sp(sc, state, lz_carry)
            a_rows.append(np.asarray(a))
            b_rows.append(np.asarray(b))
            alive_rows.append(np.asarray(al))
            iters += ln
        rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
        total += _chunk_quadrature_total(a_rows, b_rows, alive_rows, znorm2, k)
        if verbose:
            rel = float(np.max(rnorm_h / np.maximum(bnorm, 1e-30)))
            print(
                f"[fused_cg_slq] probe chunk {c + 1}/{len(sizes)}: "
                f"cg_iters={iters} max_rel_resid={rel:.3e}", flush=True,
            )

    # Leftover plain-CG segments to tolerance (bounded programs).  Traced
    # LAZILY: the common case converges inside the probe phase, and tracing
    # a scan of cg_segment_iters matrix-free applies costs real host time
    # per call (round-5 review).
    cg_prog = None
    leftover = max(0, int(cg_iters) - iters)
    for s in range(max(0, -(-leftover // int(cg_segment_iters)))):
        if not np.any((rnorm_h > stop) & ~dead_h):
            break
        if cg_prog is None:

            def cg_seg_fn(st):
                pstep = _make_pcg_step(op, lambda rr_: rr_, _colsum, _bc)
                st, _ = lax.scan(
                    lambda s_, _: (pstep(*s_), None), st, None,
                    length=int(cg_segment_iters),
                )
                return st, _colnorm(st[1]), st[5]

            sp2, sc2 = explicit_closure(cg_seg_fn, sds(state))
            cg_prog = (jax.jit(sp2), sc2)
        state, rnorm, dead = cg_prog[0](cg_prog[1], state)
        rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
        iters += int(cg_segment_iters)
        if verbose:
            rel = float(np.max(rnorm_h / np.maximum(bnorm, 1e-30)))
            print(
                f"[fused_cg_slq] cg segment {s + 1}: iters={iters} "
                f"max_rel_resid={rel:.3e}", flush=True,
            )

    return state[0], total / int(num_probes), iters
