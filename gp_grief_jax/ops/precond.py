"""CG preconditioners for the structured GP operators.

The reference has no preconditioning (its CG wraps scipy's — SURVEY.md §2 #7);
these are additions that plug into ``cg_solve``'s ``M_inv`` hook:

* :func:`kron_deflation_preconditioner` — for the grid operator
  ``A = ⊗K_d + σ²I``: deflate the top-p Kronecker eigenpairs.  With
  ``A = QΛQᵀ + σ²I`` and ``Q_p`` the selected eigencolumns,
  ``M = Q_p Λ_p Q_pᵀ + σ²I`` has the closed-form inverse

      M⁻¹ = σ⁻² I + Q_p ((Λ_p + σ²)⁻¹ − σ⁻²) Q_pᵀ

  applied with two structured Kron matvecs (``⊗Q_dᵀ`` then ``⊗Q_d``) and a
  p-entry gather/scatter on the eigen-lattice — never materializing ``Q_p``.
  For kernels with fast eigendecay (RBF grids) this collapses the CG
  iteration count; cost is ~2 extra matvec-equivalents per iteration.

* :func:`lowrank_preconditioner` — Woodbury inverse of ``U diag(λ) Uᵀ + σ²I``
  for an explicit skinny basis ``U (n, k)`` (Nyström / SKI-grid eigenfeature
  style, the GPyTorch-preconditioner pattern from PAPERS.md).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from gp_grief_jax.ops.kron_fast import kron_matvec_fast

__all__ = [
    "kron_deflation_preconditioner",
    "lowrank_preconditioner",
    "lowrank_spectral_factor",
    "lowrank_sqrt_ops",
    "lowrank_sqrt_ops_from_factor",
    "pivoted_cholesky",
]


def kron_deflation_preconditioner(
    Qs: Sequence[jax.Array],
    lams: Sequence[jax.Array],
    idx: jax.Array,
    sigma2,
    *,
    precision=lax.Precision.HIGHEST,
) -> Callable[[jax.Array], jax.Array]:
    """Deflation preconditioner for ``⊗K_d + σ²I`` from top-p eigenpairs.

    Args:
      Qs/lams: per-dimension eigenvectors/eigenvalues (``kron_eigh`` output).
      idx: ``(p, d)`` per-dimension eigen-column indices of the selected
        Kronecker eigenpairs (``top_p_kron_eigs`` output).
      sigma2: the diagonal shift.

    Returns an SPD ``M_inv(v)`` closure for ``cg_solve``; ``v`` may be
    ``(m,)`` or ``(m, B)``.  For a whitened-basis solve (required whenever
    ``σ² < ε_f32·λmax``), use
    :func:`kron_deflation_sqrt_ops`.
    """
    M_inv, _, _ = kron_deflation_sqrt_ops(
        Qs, lams, idx, sigma2, precision=precision
    )
    return M_inv


def kron_deflation_sqrt_ops(
    Qs: Sequence[jax.Array],
    lams: Sequence[jax.Array],
    idx: jax.Array,
    sigma2,
    *,
    precision=lax.Precision.HIGHEST,
):
    """Closed-form ``(M_inv, M_inv_sqrt, logdet_M)`` of the rank-p Kronecker
    deflation ``M = Q_p Λ_p Q_pᵀ + σ²I`` (see
    :func:`kron_deflation_preconditioner`): spectral functions act as
    ``f(M) = f(σ²)·I + Q_p (f(λ+σ²) − f(σ²)) Q_pᵀ`` with ``Q_p`` applied via
    two structured Kron matvecs and a p-entry eigen-lattice gather/scatter.
    ``M_inv_sqrt`` enables whitened CG/SLQ on the grid operator
    (``log|A| = logdet_M + log|M⁻½AM⁻½|``) — data-space PCG freezes whenever
    ``σ² < ε_f32·λmax``: the deflated directions' curvature falls below the
    matvec's output rounding."""
    Qs = tuple(Qs)
    sizes = [int(Q.shape[0]) for Q in Qs]
    m = math.prod(sizes)
    lam_p = jnp.ones((idx.shape[0],), dtype=Qs[0].dtype)
    for d in range(len(Qs)):
        lam_p = lam_p * jnp.take(lams[d], idx[:, d])
    # Flat index of each selected eigenpair on the eigen-lattice (C-order).
    strides = []
    s = 1
    for md in reversed(sizes):
        strides.append(s)
        s *= md
    strides = jnp.asarray(list(reversed(strides)), dtype=idx.dtype)  # (d,)
    flat = jnp.sum(idx * strides[None, :], axis=1)  # (p,)
    QT = tuple(Q.T for Q in Qs)

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        coef = diag_fun(lam_p + sigma2) - base  # (p,)

        def op(v: jax.Array) -> jax.Array:
            squeeze = v.ndim == 1
            vv = v[:, None] if squeeze else v
            z = kron_matvec_fast(QT, vv, precision=precision)  # eigen basis
            zp = z[flat, :] * coef[:, None]
            u = jnp.zeros((m, vv.shape[1]), dtype=vv.dtype).at[flat, :].set(zp)
            out = base * vv + kron_matvec_fast(Qs, u, precision=precision)
            return out[:, 0] if squeeze else out

        return op

    logdet_M = jnp.sum(jnp.log(lam_p + sigma2)) + (m - idx.shape[0]) * jnp.log(
        sigma2
    )
    return _apply(lambda s_: 1.0 / s_), _apply(lambda s_: 1.0 / jnp.sqrt(s_)), logdet_M


def lowrank_sqrt_ops(
    U: jax.Array,
    lam: jax.Array,
    sigma2,
    *,
    layout: str = "col",
    precision=lax.Precision.HIGHEST,
):
    """Closed-form operators of ``M = U diag(λ) Uᵀ + σ²I`` for ORTHONORMAL
    skinny ``U (n, r)``: returns ``(M_inv, M_inv_sqrt, logdet_M)``.

    Because ``U`` is orthonormal, every function of ``M`` acts spectrally:
    ``f(M) = f(σ²)·I + U (f(λ+σ²) − f(σ²)) Uᵀ``.  ``M_inv_sqrt`` enables
    *preconditioned SLQ*: ``log|A| = log|M| + log|M^{-1/2} A M^{-1/2}|``, and
    the whitened operator's spectrum is clustered at 1, so the Lanczos
    quadrature converges in a handful of nodes (the GPyTorch preconditioned-
    logdet pattern, PAPERS.md).

    ``layout="bm"``: the returned operators map ``(B, n) → (B, n)`` rows
    (the ``ops.cg`` batch-major contract) instead of ``(n,)``/``(n, B)``
    columns.
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    lam_shift = lam + sigma2

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        delta = diag_fun(lam_shift) - base  # (r,)

        def op(v: jax.Array) -> jax.Array:
            # HIGHEST precision: a DEFAULT f32 matmul runs in TF32 on the
            # GPU — a ~1e-3-rounded M⁻¹ is no longer SPD-symmetric to the CG
            # recurrence and rᵀM⁻¹r can go negative (breakdown guard then
            # freezes the column mid-solve); exact-f32 products keep the
            # preconditioner an honest SPD operator.
            if layout == "bm":
                t = jnp.matmul(v, U, precision=precision)  # (B, r)
                return base * v + jnp.matmul(
                    t * delta[None, :], U.T, precision=precision
                )
            squeeze = v.ndim == 1
            vv = v[:, None] if squeeze else v
            t = jnp.matmul(U.T, vv, precision=precision)  # (r, B)
            out = base * vv + jnp.matmul(
                U, delta[:, None] * t, precision=precision
            )
            return out[:, 0] if squeeze else out

        return op

    M_inv = _apply(lambda s: 1.0 / s)
    M_inv_sqrt = _apply(lambda s: 1.0 / jnp.sqrt(s))
    n = U.shape[0]
    logdet_M = jnp.sum(jnp.log(lam_shift)) + (n - lam.shape[0]) * jnp.log(sigma2)
    return M_inv, M_inv_sqrt, logdet_M


def lowrank_preconditioner(
    U: jax.Array,
    lam: jax.Array,
    sigma2,
    *,
    precision=lax.Precision.HIGHEST,
) -> Callable[[jax.Array], jax.Array]:
    """Woodbury inverse of ``M = U diag(λ) Uᵀ + σ²I`` for skinny ``U (n, k)``.

    ``M⁻¹ v = (v − U C⁻¹ Uᵀ v)/σ²`` with ``C = σ² diag(1/λ) + UᵀU`` (k×k).
    ``λ`` must be positive (SPD preconditioner).  ``precision`` defaults to
    HIGHEST — see :func:`lowrank_sqrt_ops` for why bf16-DEFAULT products
    break preconditioned CG.
    """
    C = sigma2 * jnp.diag(1.0 / lam) + jnp.matmul(U.T, U, precision=precision)
    L = jnp.linalg.cholesky(C)

    def M_inv(v: jax.Array) -> jax.Array:
        squeeze = v.ndim == 1
        vv = v[:, None] if squeeze else v
        t = jnp.matmul(U.T, vv, precision=precision)
        t = jax.scipy.linalg.cho_solve((L, True), t)
        out = (vv - jnp.matmul(U, t, precision=precision)) / sigma2
        return out[:, 0] if squeeze else out

    return M_inv


def lowrank_spectral_factor(
    F: jax.Array,
    *,
    weights: jax.Array | None = None,
    top_r: int | None = None,
):
    """f32-robust spectral form of ``F diag(w) Fᵀ``: returns ``(U, lam)``
    with ORTHONORMAL ``U (n, r)`` and ``lam ≥ 0`` such that
    ``F diag(w) Fᵀ = U diag(lam) Uᵀ`` — the input :func:`lowrank_sqrt_ops`
    needs (concrete arrays, so they can be computed once in one jitted
    program and shared across separately-dispatched segment programs).

    ``top_r``: keep only the ``top_r`` LARGEST eigenpairs (``lam`` stays
    ascending, so these are the trailing columns — the slicing convention
    the deflation callers use).  Slicing *before* the final ``Ut·V`` GEMM
    skips materializing the discarded columns: at the uci2m operating point
    (n=1.84M, p=400, r=300) every (n, p) f32 buffer is 2.9 GB.

    Why the two-stage build (measured at the n=100k SKI config):

    * a one-shot eigh of the weighted Gram ``(F√w)ᵀ(F√w)`` — condition
      ~ w₁/w_r · κ(F)² — returns a basis so far from orthonormal in f32
      that ``M⁻¹`` loses positive-definiteness and preconditioned CG
      *diverges*.  Instead, orthonormalize ``F`` FIRST (CholeskyQR, twice —
      the CholeskyQR2 pattern pushes orthonormality to working eps), then
      eigendecompose the r×r congruence ``LᵀWL`` which only needs absolute
      ``eps·λ₁`` accuracy;
    * eigh / cholesky / triangular_solve are blocked algorithms whose inner
      dots follow the *default* matmul precision (TF32 on the GPU) — the
      whole build runs under ``jax.default_matmul_precision("highest")``.
    """
    from gp_grief_jax.ops.solve import stable_cholesky

    with jax.default_matmul_precision("highest"):
        hi = lax.Precision.HIGHEST
        Ut = F
        Ls = []
        for _ in range(2):
            G = jnp.matmul(Ut.T, Ut, precision=hi)
            L, _ = stable_cholesky(G)
            # Right-sided solve Ut ← Ut·L⁻ᵀ directly (x·Lᵀ = Ut): the
            # left-sided jax.scipy form materializes TWO (p, n) transposes
            # of the tall operand per iteration — 4 extra data-sized
            # buffers at the 1.9M-point scale (the memory peak above).
            Ut = lax.linalg.triangular_solve(
                L, Ut, left_side=False, lower=True, transpose_a=True
            )
            Ls.append(L)
        # F = Ut·(L2ᵀL1ᵀ)  ⇒  F W Fᵀ = Ut (L2ᵀL1ᵀ W L1L2) Utᵀ.
        mid = jnp.matmul(Ls[1].T, Ls[0].T, precision=hi)
        if weights is not None:
            mid = mid * jnp.sqrt(weights)[None, :]
        s, V = jnp.linalg.eigh(jnp.matmul(mid, mid.T, precision=hi))
        lam = jnp.maximum(s, 0.0)
        if top_r is not None:
            r = max(0, int(min(top_r, lam.shape[0])))
            k = lam.shape[0] - r  # explicit start: -0 would slice ALL columns
            V, lam = V[:, k:], lam[k:]
        U = jnp.matmul(Ut, V, precision=hi)
    return U, lam


def lowrank_sqrt_ops_from_factor(
    F: jax.Array,
    sigma2,
    *,
    weights: jax.Array | None = None,
    layout: str = "col",
):
    """:func:`lowrank_sqrt_ops` of ``M = F diag(w) Fᵀ + σ²I`` built from a
    RAW (non-orthonormal) skinny factor via :func:`lowrank_spectral_factor`
    (see there for the f32 robustness rationale)."""
    U, lam = lowrank_spectral_factor(F, weights=weights)
    return lowrank_sqrt_ops(U, lam, sigma2, layout=layout)


def pivoted_cholesky(K: jax.Array, rank: int) -> jax.Array:
    """Partial pivoted Cholesky of a dense SPD Gram: ``K ≈ L Lᵀ`` with
    ``L (n, rank)`` built greedily on the largest remaining diagonal.

    The GPyTorch-preconditioner pattern (PAPERS.md): ``M = LLᵀ + σ²I``
    captures the dominant spectrum of smooth kernels in a few columns.
    Jittable: a ``lax.scan`` of ``rank`` steps, each one argmax + one row
    gather + a rank-1 diagonal update (O(n·rank) total).  Exhausted
    diagonals (rank ≥ numerical rank of ``K``) yield zero columns, which
    downstream spectral ops treat as inert.  Gather/update products run at
    HIGHEST precision for the same SPD-consistency reasons as
    :func:`lowrank_sqrt_ops`.
    """
    return pivoted_cholesky_matfree(
        lambda piv: K[:, piv], jnp.diagonal(K), rank
    )


def pivoted_cholesky_matfree(row_fn, diag: jax.Array, rank: int) -> jax.Array:
    """:func:`pivoted_cholesky` from ROW ACCESS only — no (n, n) Gram.

    ``row_fn(i) -> K[i, :]`` (a traced scalar index; symmetric ``K`` so rows
    are columns) and ``diag = diag(K)``.  The greedy build touches exactly
    ``rank`` rows, each one an O(n·d) kernel evaluation for the matrix-free
    exact-GP path (round-3 missing #2) — the only place the large-n
    iterative model ever instantiates kernel entries outside the chunked
    matvec."""
    n = diag.shape[0]
    rank = int(min(rank, n))
    hi = lax.Precision.HIGHEST

    # The scan threads the growing L as a fixed (rank, n) buffer (rows are
    # built columns of Lᵀ); step j writes row j via a one-hot outer product
    # (branch-free — dynamic_update_slice on a traced index would also work
    # but the one-hot form keeps the whole step a fused VPU pipeline).
    def step(carry, j):
        d, Lrows = carry
        piv = jnp.argmax(d)
        # Schur-complement column at the pivot: K[:, piv] − L L[piv,:]ᵀ.
        # Dtype-stable: under x64 test configs the kernel params are f64
        # over f32 data, so row_fn promotes — pin the row to the carry's
        # dtype (same rule as make_gram_matvec's output dtype).
        row = row_fn(piv).astype(diag.dtype)
        col = row - jnp.matmul(Lrows.T, Lrows[:, piv], precision=hi)
        dpiv = d[piv]
        # Exhausted diagonal ⇒ inert zero column (scan is branch-free).
        scale = jnp.where(dpiv > 0, lax.rsqrt(jnp.where(dpiv > 0, dpiv, 1.0)), 0.0)
        lj = col * scale
        d_new = jnp.maximum(d - lj * lj, 0.0)
        onehot = (jnp.arange(rank) == j).astype(diag.dtype)
        Lrows = Lrows + onehot[:, None] * lj[None, :]
        return (d_new, Lrows), None

    Lrows0 = jnp.zeros((rank, n), diag.dtype)
    (_, Lrows), _ = lax.scan(step, (diag, Lrows0), jnp.arange(rank))
    return Lrows.T  # (n, rank)
