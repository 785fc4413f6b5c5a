"""Lanczos tridiagonalization and stochastic Lanczos quadrature (SLQ) log-det.

JAX re-design of the reference's ``linalg.lanczos`` + stochastic
log-det estimator (reference: ``gp_grief/linalg.py`` — SURVEY.md §2 #8; SLQ
after Dong et al. 2017, "Scalable Log Determinants", PAPERS.md).  The Lanczos
recurrence is a fixed-length ``lax.scan`` (static shapes for jit), optionally
with full reorthogonalization against the stored basis — needed in f32 where
the three-term recurrence loses orthogonality within ~20 iterations.  SLQ draws
Rademacher probes and is ``vmap``-ed over them, so all probes run as one
batched program; the probe loop, the recurrence, and the small ``k×k`` ``eigh``
stay on-device end to end.  At the 2M-point scale SLQ runs with
``store_basis=False`` so memory stays ``O(R·m)``, not ``O(R·m·k)``.

Gradients of a log-det are handled at the model layer via the Hutchinson
identity ``∂ log|A| = tr(A⁻¹ ∂A)`` with CG solves (BBMM pattern, PAPERS.md),
not by differentiating through this estimator.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "lanczos",
    "lanczos_batched",
    "slq_logdet",
    "slq_logdet_segmented",
    "LanczosResult",
]


class LanczosResult(NamedTuple):
    Q: Optional[jax.Array]  # (m, k) orthonormal basis, or None if not stored
    alpha: jax.Array  # (k,) tridiagonal diagonal (zero-padded past breakdown)
    beta: jax.Array  # (k-1,) tridiagonal off-diagonal (zero-padded)
    num_valid: jax.Array  # scalar int32: valid alpha entries before breakdown


def lanczos(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    k: int,
    *,
    full_reorth: bool = True,
    store_basis: bool = True,
    axis_name: Optional[str] = None,
) -> LanczosResult:
    """Run ``k`` Lanczos steps of a symmetric operator from start vector ``v0``.

    Produces tridiagonal ``T = tridiag(beta, alpha, beta)`` with
    ``Qᵀ A Q = T`` and (optionally) the orthonormal basis ``Q``.  Breakdown
    (an exactly-captured invariant subspace) is masked, not branched on:
    iterations past breakdown yield zero columns and zero ``alpha``/``beta``
    entries, and ``num_valid`` reports the usable count — shapes stay static.

    ``full_reorth=True`` requires ``store_basis=True``.  With ``axis_name``
    set (inside ``shard_map``) the vectors are row-sharded over that mesh axis
    and all inner products/norms are ``psum``-reduced.
    """
    if full_reorth and not store_basis:
        raise ValueError("full_reorth requires store_basis=True")
    m = v0.shape[0]
    dtype = v0.dtype
    eps = jnp.finfo(dtype).eps

    def _sum(t):
        s = jnp.sum(t)
        return lax.psum(s, axis_name) if axis_name is not None else s

    def _dot(a, b):
        return _sum(a * b)

    def _norm(t):
        return jnp.sqrt(_sum(t * t))

    q0 = v0 / _norm(v0)

    def step(carry, i):
        q, q_prev, beta_prev, Qbuf, alive = carry
        if store_basis:
            Qbuf = Qbuf.at[:, i].set(jnp.where(alive, q, jnp.zeros_like(q)))
        w = matvec(q[:, None])[:, 0]
        alpha_i = _dot(w, q)
        w = w - alpha_i * q - beta_prev * q_prev
        if full_reorth:
            # Orthogonalize against all stored vectors (zeros beyond i are
            # inert).  Two passes: "twice is enough" (Parlett).
            for _ in range(2):
                coeffs = Qbuf.T @ w
                if axis_name is not None:
                    coeffs = lax.psum(coeffs, axis_name)
                w = w - Qbuf @ coeffs
        beta_i = _norm(w)
        scale = jnp.abs(alpha_i) + beta_prev + jnp.asarray(1.0, dtype)
        broke = beta_i <= 100 * eps * scale
        q_next = jnp.where(
            broke, jnp.zeros_like(w), w / jnp.where(beta_i == 0, 1.0, beta_i)
        )
        alpha_out = jnp.where(alive, alpha_i, 0.0)
        beta_out = jnp.where(jnp.logical_and(alive, ~broke), beta_i, 0.0)
        alive_next = jnp.logical_and(alive, ~broke)
        return (q_next, q, beta_out, Qbuf, alive_next), (alpha_out, beta_out, alive)

    Qbuf0 = jnp.zeros((m, k), dtype) if store_basis else jnp.zeros((m, 0), dtype)
    init = (
        q0,
        jnp.zeros_like(q0),
        jnp.asarray(0.0, dtype),
        Qbuf0,
        jnp.asarray(True),
    )
    (_, _, _, Qbuf, _), (alphas, betas, alive_flags) = lax.scan(
        step, init, jnp.arange(k)
    )
    return LanczosResult(
        Q=Qbuf if store_basis else None,
        alpha=alphas,
        beta=betas[:-1],
        num_valid=jnp.sum(alive_flags.astype(jnp.int32)),
    )


def lanczos_batched(
    matvec: Callable[[jax.Array], jax.Array],
    V0: jax.Array,
    k: int,
    *,
    axis_name: Optional[str] = None,
    layout: str = "col",
):
    """``R`` independent Lanczos recurrences sharing each batched matvec.

    ``V0``: ``(m, R)`` start vectors; ``matvec`` maps ``(m, R) → (m, R)``
    column-wise (the same contract as :func:`gp_grief_jax.ops.cg.cg_solve`).
    With ``layout="bm"`` the contract flips to ``(R, m)`` — each ROW a
    recurrence, the long axis contiguous (see ``ops.cg._reducers``).
    Returns ``(alphas (k, R), betas (k-1, R), num_valid (R,))`` — the
    per-column tridiagonals, zero-padded past each column's breakdown.

    Exists for the SLQ probe loop: ``vmap``-ing the single-vector
    :func:`lanczos` makes every operator-internal ``(m, 1)`` intermediate a
    ``(R, m, 1)`` batch with a trailing unit dimension.  Batching probes as
    *columns* keeps one
    ``(m, R)`` block and lets structured operators fold ``R`` into their
    lattice (e.g. ``I_R ⊗ (⊗K_d)``).  No reorthogonalization (use
    :func:`lanczos` with ``full_reorth`` for small-m high-accuracy checks).
    """
    from gp_grief_jax.ops.cg import _reducers

    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    R = V0.shape[1] if layout == "col" else V0.shape[0]
    dtype = V0.dtype

    _colsum, _colnorm, _bc = _reducers(layout, axis_name)

    q0 = V0 / _bc(_colnorm(V0))
    step = _make_lanczos_step(matvec, _colsum, _colnorm, _bc, dtype)
    init = (q0, jnp.zeros_like(q0), jnp.zeros((R,), dtype), jnp.ones((R,), bool))
    _, (alphas, betas, alive_flags) = lax.scan(step, init, None, length=k)
    return alphas, betas[:-1], jnp.sum(alive_flags.astype(jnp.int32), axis=0)


def _make_lanczos_step(matvec, _colsum, _colnorm, _bc, dtype):
    """One batched-Lanczos iteration on carry ``(q, q_prev, beta_prev,
    alive)`` — shared by :func:`lanczos_batched`, the iteration-segmented
    SLQ, and (arithmetically) ``ops.fused``."""
    eps = jnp.finfo(dtype).eps

    def step(carry, _):
        q, q_prev, beta_prev, alive = carry
        w = matvec(q)
        alpha_i = _colsum(w * q)  # (R,)
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
        return (q_next, q, beta_out, alive_next), (alpha_out, beta_out, alive)

    return step


def _slq_quadrature(alpha_col, beta_col, num_valid, k):
    """Gauss-quadrature value ``Σ_j τ_j² log θ_j`` of one probe's tridiagonal."""
    T = jnp.diag(alpha_col) + jnp.diag(beta_col, 1) + jnp.diag(beta_col, -1)
    live = jnp.arange(k) < num_valid
    T = jnp.where(live[:, None] & live[None, :], T, 0.0)
    T = T + jnp.diag(jnp.where(live, 0.0, 1.0))
    theta, V = jnp.linalg.eigh(T)
    tau = V[0, :]
    theta_safe = jnp.where(theta > 0, theta, 1.0)
    return jnp.sum(tau * tau * jnp.log(theta_safe))


def _slq_single_probe(matvec, z, k, full_reorth, axis_name=None):
    """SLQ contribution of one probe: ``‖z‖² · Σ_j τ_j² log θ_j``."""
    res = lanczos(
        matvec, z, k, full_reorth=full_reorth, store_basis=full_reorth,
        axis_name=axis_name,
    )
    T = jnp.diag(res.alpha) + jnp.diag(res.beta, 1) + jnp.diag(res.beta, -1)
    # Neutralize the dead (post-breakdown) block: unit diagonal there makes
    # eigh well posed, and its Gauss weight is zero because those eigenpairs
    # land in the θ=1 eigenspace where log θ = 0.
    live = jnp.arange(k) < res.num_valid
    T = jnp.where(live[:, None] & live[None, :], T, 0.0)
    T = T + jnp.diag(jnp.where(live, 0.0, 1.0))
    theta, V = jnp.linalg.eigh(T)
    tau = V[0, :]
    znorm2 = jnp.sum(z * z)
    if axis_name is not None:
        znorm2 = lax.psum(znorm2, axis_name)
    theta_safe = jnp.where(theta > 0, theta, 1.0)
    return znorm2 * jnp.sum(tau * tau * jnp.log(theta_safe))


def slq_logdet(
    matvec: Callable[[jax.Array], jax.Array],
    m: int,
    *,
    key: jax.Array,
    num_probes: int = 32,
    lanczos_iters: int = 64,
    dtype=jnp.float32,
    full_reorth: bool = False,
    axis_name: Optional[str] = None,
    layout: str = "col",
) -> jax.Array:
    """Estimate ``log|A|`` for symmetric PD ``A`` via stochastic Lanczos quadrature.

    ``log|A| = tr(log A) ≈ (1/R) Σ_r zᵀ log(A) z`` with Rademacher probes
    ``z``, each quadratic form evaluated by ``lanczos_iters`` Lanczos steps
    (Gauss quadrature on the spectral measure).  All probes run batched under
    ``vmap``; cost ``R · k`` matvecs, memory ``O(R·m)`` with the default
    ``full_reorth=False`` (use ``True`` for small-``m`` high-accuracy checks).

    ``layout="bm"``: probes are ROWS of an ``(R, m)`` block and ``matvec``
    maps ``(R, m) → (R, m)`` — the long axis stays contiguous (see
    :func:`lanczos_batched`).  Incompatible
    with ``full_reorth``.
    """
    if layout == "bm" and full_reorth:
        raise ValueError("layout='bm' does not support full_reorth")
    if axis_name is not None:
        # Each shard draws its own slice of every probe: fold the device index
        # into the key so the global Rademacher vector is well defined.
        key = jax.random.fold_in(key, lax.axis_index(axis_name))
    if full_reorth:
        # High-accuracy small-m path: per-probe recurrences under vmap.
        z = jax.random.rademacher(key, (num_probes, m), dtype=dtype)
        vals = jax.vmap(
            lambda zz: _slq_single_probe(matvec, zz, lanczos_iters, full_reorth, axis_name)
        )(z)
        return jnp.mean(vals)
    # Default: probes batched as COLUMNS through one (m, R) recurrence —
    # every matvec is a single batched call, and no (R, m, 1) vmap
    # intermediates appear (see lanczos_batched).  "bm" runs the same recurrence on (R, m) rows.
    shape = (m, num_probes) if layout == "col" else (num_probes, m)
    Z = jax.random.rademacher(key, shape, dtype=dtype)
    alphas, betas, num_valid = lanczos_batched(
        matvec, Z, lanczos_iters, axis_name=axis_name, layout=layout
    )
    znorm2 = jnp.sum(Z * Z, axis=0 if layout == "col" else 1)
    if axis_name is not None:
        znorm2 = lax.psum(znorm2, axis_name)
    vals = jax.vmap(
        lambda a, b, nv, zn: zn * _slq_quadrature(a, b, nv, lanczos_iters),
        in_axes=(1, 1, 0, 0),
    )(alphas, betas, num_valid, znorm2)
    return jnp.mean(vals)


def slq_logdet_segmented(
    matvec: Callable[[jax.Array], jax.Array],
    m: int,
    *,
    key: jax.Array,
    num_probes: int = 32,
    lanczos_iters: int = 64,
    dtype=jnp.float32,
    layout: str = "bm",
    probe_chunk: int = 8,
    iter_segment: Optional[int] = None,
) -> float:
    """Host-chunked SLQ log-det: probes run ``probe_chunk`` at a time, each
    chunk one jitted device program (the :func:`slq_logdet` batched estimator
    with chunk ``c``'s probes drawn from ``fold_in(key, c)`` — the union over
    chunks is the same i.i.d. Rademacher family, so the estimator is
    unchanged; only its probe partitioning differs).

    Why: one monolithic SLQ program runs ``num_probes × lanczos_iters``
    matvecs; chunking bounds each program at ``probe_chunk ×
    lanczos_iters`` matvecs (and its live probe block at ``probe_chunk``
    rows).  Returns a host float.

    ``iter_segment``: additionally segment the Lanczos RECURRENCE — each
    device program advances only ``iter_segment`` iterations, with the
    recurrence carry (q, q_prev, β, alive) device-resident between
    dispatches and the (tiny) per-iteration α/β fetched to host, where the
    Gauss quadrature runs in f64.  Needed when a single matvec costs
    seconds (the matrix-free exact-GP operator at n ≥ 500k rebuilds the
    Gram block-by-block).  Same recurrence arithmetic and
    probe draws; only the program partitioning differs.
    """
    if num_probes <= 0:
        raise ValueError("num_probes must be positive")
    from gp_grief_jax.utils.closure import explicit_closure

    sizes = _probe_chunk_sizes(num_probes, probe_chunk)
    # Captured operands (plan tables, preconditioner factors inside a
    # whitened matvec) are hoisted into explicit jit arguments — see
    # gp_grief_jax.utils.closure (multi-GB closures must never be embedded
    # in the lowered program).
    key_sds = jax.ShapeDtypeStruct(key.shape, key.dtype)
    if iter_segment is not None:
        return _slq_logdet_iter_segmented(
            matvec, m, key, sizes, num_probes, int(lanczos_iters),
            int(iter_segment), dtype, layout,
        )
    progs = {}
    total = 0.0
    for c, r in enumerate(sizes):
        if r not in progs:

            def chunk_fn(k, rr=r):
                return slq_logdet(
                    matvec, m, key=k, num_probes=rr,
                    lanczos_iters=lanczos_iters, dtype=dtype, layout=layout,
                )

            pure, consts = explicit_closure(chunk_fn, key_sds)
            progs[r] = (jax.jit(pure), consts)
        prog, consts = progs[r]
        # Per-chunk fetch: bounds the device queue at one chunk.
        total += float(prog(consts, jax.random.fold_in(key, c))) * r
    return total / num_probes


def _slq_logdet_iter_segmented(
    matvec, m, key, sizes, num_probes, k, seg, dtype, layout
) -> float:
    """Iteration-segmented SLQ driver (see :func:`slq_logdet_segmented`)."""
    from gp_grief_jax.ops.cg import _reducers
    from gp_grief_jax.utils.closure import explicit_closure

    _colsum, _colnorm, _bc = _reducers(layout, None)
    seg = max(1, min(seg, k))
    key_sds = jax.ShapeDtypeStruct(key.shape, key.dtype)

    # Segment lengths: full `seg`-iteration programs plus ONE remainder
    # program — each matvec can cost seconds here, so running ceil(k/seg)·seg
    # iterations and discarding the overshoot would waste up to seg−1
    # matvecs per probe chunk (round-4 review).
    seg_lens = [seg] * (k // seg)
    if k % seg:
        seg_lens.append(k % seg)

    init_progs, seg_progs = {}, {}
    total = 0.0
    for c, r in enumerate(sizes):
        if r not in init_progs:

            def init_fn(kk, rr=r):
                shape = (m, rr) if layout == "col" else (rr, m)
                Z = jax.random.rademacher(kk, shape, dtype=dtype)
                q0 = Z / _bc(_colnorm(Z))
                znorm2 = _colsum(Z * Z)
                carry = (
                    q0, jnp.zeros_like(q0), jnp.zeros((rr,), dtype),
                    jnp.ones((rr,), bool),
                )
                return carry, znorm2

            ip, ic = explicit_closure(init_fn, key_sds)
            init_progs[r] = (jax.jit(ip), ic)
        ip, ic = init_progs[r]
        carry_sds = jax.eval_shape(ip, ic, key_sds)[0]
        for ln in set(seg_lens):
            if (r, ln) not in seg_progs:

                def seg_fn(carry, _ln=ln):
                    step = _make_lanczos_step(
                        matvec, _colsum, _colnorm, _bc, dtype
                    )
                    carry, outs = lax.scan(step, carry, None, length=_ln)
                    return carry, outs  # outs: (ln, R) alphas/betas/alive

                sp, sc = explicit_closure(seg_fn, carry_sds)
                seg_progs[(r, ln)] = (jax.jit(sp), sc)
        carry, znorm2 = ip(ic, jax.random.fold_in(key, c))
        a_rows, b_rows, alive_rows = [], [], []
        for ln in seg_lens:
            sp, sc = seg_progs[(r, ln)]
            carry, (a, b, al) = sp(sc, carry)
            # Per-segment fetch: tiny (ln, R) blocks — the host sync that
            # bounds each device program at `ln` matvecs.
            a_rows.append(np.asarray(a))
            b_rows.append(np.asarray(b))
            alive_rows.append(np.asarray(al))
        total += _chunk_quadrature_total(a_rows, b_rows, alive_rows, znorm2, k)
    return total / num_probes


def _probe_chunk_sizes(num_probes: int, probe_chunk: int) -> list:
    """Partition ``num_probes`` i.i.d. probes into device-program chunks."""
    probe_chunk = max(1, min(int(probe_chunk), int(num_probes)))
    sizes = [probe_chunk] * (int(num_probes) // probe_chunk)
    if int(num_probes) % probe_chunk:
        sizes.append(int(num_probes) % probe_chunk)
    return sizes


def _chunk_quadrature_total(a_rows, b_rows, alive_rows, znorm2, k: int) -> float:
    """Host-f64 SLQ quadrature for one probe chunk from per-segment α/β/alive
    fetches (each ``(ln, R)``) — shared by the iteration-segmented SLQ and
    the fused CG+SLQ driver (``ops.fused``), so the two estimators cannot
    silently diverge."""
    alphas = np.concatenate(a_rows).astype(np.float64)
    betas = np.concatenate(b_rows).astype(np.float64)
    alive = np.concatenate(alive_rows)
    num_valid = alive.sum(axis=0)
    zn = np.asarray(znorm2, dtype=np.float64)
    total = 0.0
    for j in range(zn.shape[0]):
        total += zn[j] * _np_slq_quadrature(
            alphas[:, j], betas[: k - 1, j], int(num_valid[j]), k
        )
    return total


def _np_slq_quadrature(alpha_col, beta_col, num_valid, k) -> float:
    """Host-f64 mirror of :func:`_slq_quadrature` (segmented driver)."""
    T = np.diag(alpha_col) + np.diag(beta_col, 1) + np.diag(beta_col, -1)
    live = np.arange(k) < num_valid
    T = np.where(live[:, None] & live[None, :], T, 0.0)
    T = T + np.diag(np.where(live, 0.0, 1.0))
    theta, V = np.linalg.eigh(T)
    tau = V[0, :]
    theta_safe = np.where(theta > 0, theta, 1.0)
    return float(np.sum(tau * tau * np.log(theta_safe)))
