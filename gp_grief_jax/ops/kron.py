"""Kronecker-product linear algebra as pure functions on lists of factor matrices.

JAX re-design of the reference's ``KronMatrix`` lazy-operator class
(reference: ``gp_grief/tensors.py``, class ``KronMatrix`` — see SURVEY.md §2 #1).
Instead of an OO operator with a ``__mul__`` loop, a Kronecker matrix is a plain
pytree — a tuple of per-dimension factor arrays ``(K_1, ..., K_d)`` representing
``K = K_1 ⊗ ... ⊗ K_d`` — and every operation is a jit-able, differentiable pure
function.  The matvec uses the vec-trick expressed as ``dot_general`` contractions
so XLA hands it to its matrix-product kernels; there are no data-dependent
shapes anywhere.

Conventions
-----------
* Factor ``K_d`` has shape ``(q_d, m_d)``; the operator maps ``prod(m_d) ->
  prod(q_d)``.  Square symmetric factors enable ``eigh``/``chol`` paths.
* Vectors are flattened in C (row-major) order over the dimension axes, i.e.
  ``vec(X)[i] = X[i_1, ..., i_d]`` with ``i_1`` the slowest index — matching
  ``x.reshape(m_1, ..., m_d)``.
* Batched right-hand sides use a trailing batch axis: ``v`` of shape ``(M, B)``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

Factors = Sequence[jax.Array]

__all__ = [
    "kron_matvec",
    "kron_matmat",
    "kron_expand",
    "kron_diag",
    "kron_eigh",
    "kron_svd",
    "kron_chol",
    "kron_logdet_from_chol",
    "kron_logdet_from_eigs",
    "kron_solve_schur",
    "kron_shapes",
]


def kron_shapes(factors: Factors) -> Tuple[int, int]:
    """Total (rows, cols) of ``K_1 ⊗ ... ⊗ K_d``."""
    rows = math.prod(int(f.shape[0]) for f in factors)
    cols = math.prod(int(f.shape[1]) for f in factors)
    return rows, cols


def kron_matmat(
    factors: Factors,
    v: jax.Array,
    *,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Multiply ``(⊗_d K_d) @ v`` for a batched rhs ``v`` of shape ``(M, B)``.

    The vec-trick: reshape ``v`` to the dimension lattice ``(m_1, ..., m_d, B)``
    and contract each factor along its own axis.  Cost ``O(M · Σ_d q_d)`` (for
    square factors ``O(M · Σ m_d)``) versus ``O(M²)`` dense — the reference's
    hot primitive (SURVEY.md §3.4, ``KronMatrix.__mul__``), here emitted as a
    chain of ``dot_general`` ops.
    """
    ms = [int(f.shape[1]) for f in factors]
    B = v.shape[-1]
    with jax.named_scope("kron_matmat"):
        x = v.reshape(*ms, B)
        for d, K in enumerate(factors):
            # Contract axis d of x with the columns of K, putting the new axis
            # back in position d (tensordot -> dot_general).
            x = jnp.tensordot(K, x, axes=((1,), (d,)), precision=precision)
            x = jnp.moveaxis(x, 0, d)
        return x.reshape(-1, B)


def kron_matvec(
    factors: Factors,
    v: jax.Array,
    *,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Multiply ``(⊗_d K_d) @ v`` for ``v`` of shape ``(M,)`` or ``(M, B)``."""
    if v.ndim == 1:
        return kron_matmat(factors, v[:, None], precision=precision)[:, 0]
    return kron_matmat(factors, v, precision=precision)


def kron_expand(factors: Factors) -> jax.Array:
    """Densify ``K_1 ⊗ ... ⊗ K_d``.  Test/small-scale oracle only.

    Mirrors the reference's ``KronMatrix.expand()`` (SURVEY.md §2 #1), which the
    reference test-suite uses as ground truth for every structured op.
    """
    out = factors[0]
    for K in factors[1:]:
        out = jnp.kron(out, K)
    return out


def kron_diag(factors: Factors) -> jax.Array:
    """Diagonal of a square Kronecker product: ``⊗_d diag(K_d)`` flattened."""
    out = jnp.diagonal(factors[0])
    for K in factors[1:]:
        out = (out[:, None] * jnp.diagonal(K)[None, :]).reshape(-1)
    return out


def kron_eigh(factors: Factors) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Per-dimension symmetric eigendecomposition of a symmetric Kronecker matrix.

    ``K_d = Q_d Λ_d Q_dᵀ`` for each factor, so ``K = (⊗Q_d)(⊗Λ_d)(⊗Q_d)ᵀ``.
    This is the reference's ``KronMatrix.schur()`` (SURVEY.md §2 #1 /
    §3.1) — ``d`` small ``eigh`` calls instead of one ``m×m`` one.  When all
    factors share a size the decompositions are batched through ``vmap`` so XLA
    runs them as one batched kernel; ragged sizes fall back to a per-factor
    (trace-time unrolled) loop.

    Returns ``(Qs, lams)``: tuples of per-dim eigenvector matrices and
    ascending eigenvalue vectors.
    """
    sizes = {int(f.shape[0]) for f in factors}
    if len(sizes) == 1 and len(factors) > 1:
        stacked = jnp.stack(list(factors), axis=0)
        lams, Qs = jax.vmap(jnp.linalg.eigh)(stacked)
        return tuple(Qs[i] for i in range(len(factors))), tuple(
            lams[i] for i in range(len(factors))
        )
    out_Q, out_l = [], []
    for K in factors:
        lam, Q = jnp.linalg.eigh(K)
        out_Q.append(Q)
        out_l.append(lam)
    return tuple(out_Q), tuple(out_l)


def kron_svd(
    factors: Factors,
) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Per-factor SVD of a Kronecker matrix (reference ``KronMatrix.svd()``,
    SURVEY.md §2 #1).

    ``K_d = U_d S_d V_dᵀ`` for each factor, so ``⊗K_d = (⊗U_d)(⊗S_d)(⊗V_d)ᵀ``
    — the singular values of the product are all products of per-factor
    singular values (use :func:`kron_diag` on ``diag(S_d)`` factors, or
    ``top_p_kron_eigs`` on ``log S_d`` for the top-p subset without
    materializing ``m``).  Equal-size factors batch through ``vmap``.

    Returns ``(Us, Ss, Vs)``: tuples of per-factor left singular vectors,
    singular values (descending, per NumPy convention), and right singular
    vectors ``V_d`` (not transposed).
    """
    shapes = {tuple(int(s) for s in f.shape) for f in factors}
    if len(shapes) == 1 and len(factors) > 1:
        U, S, Vh = jax.vmap(lambda a: jnp.linalg.svd(a, full_matrices=False))(
            jnp.stack(list(factors), axis=0)
        )
        n = len(factors)
        return (
            tuple(U[i] for i in range(n)),
            tuple(S[i] for i in range(n)),
            tuple(Vh[i].T for i in range(n)),
        )
    Us, Ss, Vs = [], [], []
    for K in factors:
        U, S, Vh = jnp.linalg.svd(K, full_matrices=False)
        Us.append(U)
        Ss.append(S)
        Vs.append(Vh.T)
    return tuple(Us), tuple(Ss), tuple(Vs)


def kron_chol(factors: Factors) -> Tuple[jax.Array, ...]:
    """Per-factor Cholesky: ``chol(⊗K_d) = ⊗chol(K_d)`` (reference ``KronMatrix.chol()``)."""
    sizes = {int(f.shape[0]) for f in factors}
    if len(sizes) == 1 and len(factors) > 1:
        Ls = jax.vmap(jnp.linalg.cholesky)(jnp.stack(list(factors), axis=0))
        return tuple(Ls[i] for i in range(len(factors)))
    return tuple(jnp.linalg.cholesky(K) for K in factors)


def kron_logdet_from_chol(chol_factors: Factors) -> jax.Array:
    """``log|⊗K_d|`` from per-factor Cholesky factors.

    ``log|⊗K_d| = Σ_d (m/m_d) · log|K_d|`` where ``m = Π m_d`` (reference
    ``KronMatrix.log_det`` — SURVEY.md §2 #1).
    """
    m = math.prod(int(L.shape[0]) for L in chol_factors)
    total = jnp.zeros((), dtype=chol_factors[0].dtype)
    for L in chol_factors:
        m_d = int(L.shape[0])
        total = total + (m // m_d) * 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return total


def kron_logdet_from_eigs(lams: Factors) -> jax.Array:
    """``log|⊗K_d|`` from per-factor eigenvalues (PSD assumed)."""
    m = math.prod(int(l.shape[0]) for l in lams)
    total = jnp.zeros((), dtype=lams[0].dtype)
    for lam in lams:
        m_d = int(lam.shape[0])
        total = total + (m // m_d) * jnp.sum(jnp.log(lam))
    return total


def kron_solve_schur(
    Qs: Factors,
    lams: Factors,
    b: jax.Array,
    shift: jax.Array | float = 0.0,
    *,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Solve ``(⊗K_d + shift·I) x = b`` given per-dim eigendecompositions.

    ``x = Q (Qᵀ b / (λ_⊗ + shift))`` with ``Q = ⊗Q_d`` applied via Kron matvecs
    and ``λ_⊗ = ⊗λ_d`` formed as the flattened outer product — the reference's
    ``linalg.solve_schur`` (SURVEY.md §2 #6) fused into one jitted function.

    ``b``: shape ``(M,)`` or ``(M, B)``.
    """
    lam_kron = lams[0]
    for lam in lams[1:]:
        lam_kron = (lam_kron[:, None] * lam[None, :]).reshape(-1)
    QTs = tuple(Q.T for Q in Qs)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    z = kron_matmat(QTs, b, precision=precision)
    z = z / (lam_kron + shift)[:, None]
    x = kron_matmat(Qs, z, precision=precision)
    return x[:, 0] if squeeze else x
