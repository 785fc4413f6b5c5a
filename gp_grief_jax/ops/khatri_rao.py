"""Row-partitioned Khatri-Rao products and row/col-selected Kronecker products.

JAX re-design of the reference's ``KhatriRaoMatrix`` and
``RowColKhatriRaoMatrix`` lazy operators (reference: ``gp_grief/tensors.py`` —
SURVEY.md §2 #2–#3).  A row-partitioned Khatri-Rao matrix has row ``i`` equal to
``⊗_d A_d[i, :]`` where each ``A_d`` is ``(n, m_d)``; it is the cross-covariance
structure between ``n`` scattered points and a product grid.  We keep it as a
tuple of per-dimension arrays and expose matvec/matmat as pure functions built
from gathers + running elementwise products — `O(n · Σ m_d)` instead of
`O(n · Π m_d)`.

The row-col selected form (``RowColKhatriRaoMatrix``) is what the GRIEF basis
``Φ`` is before expansion: ``Φ[i, j] = Π_d B_d[i, idx[j, d]]`` with ``B_d``
``(n, m_d)`` and an index table ``idx`` of shape ``(p, d)``.  Here this is a
gather along the column axis of each ``B_d`` followed by an elementwise product
accumulated across dimensions — fused by XLA.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "kr_matvec",
    "kr_rmatvec",
    "kr_expand",
    "rowcol_kr_expand",
    "rowcol_kr_matvec",
    "rowcol_kr_rmatvec",
]


def kr_expand(A_list: Sequence[jax.Array]) -> jax.Array:
    """Densify a row-partitioned Khatri-Rao product: row ``i`` = ``⊗_d A_d[i]``.

    Test oracle, mirrors reference ``KhatriRaoMatrix.expand()``.
    """
    out = A_list[0]
    for A in A_list[1:]:
        n = out.shape[0]
        out = (out[:, :, None] * A[:, None, :]).reshape(n, -1)
    return out


def kr_matvec(
    A_list: Sequence[jax.Array],
    v: jax.Array,
    *,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """``KR(A_1..A_d) @ v`` where ``v`` has shape ``(Π m_d,)`` or ``(Π m_d, B)``.

    Row ``i`` of the result is ``Σ_j (Π_d A_d[i, j_d]) v[j]``.  Computed by
    contracting ``v`` (reshaped onto the dimension lattice) with one ``A_d`` at
    a time while keeping the shared row index batched — a chain of batched
    matvecs, ``O(n · Σ m_d)`` flops per rhs, all ``dot_general``.
    """
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    ms = [int(A.shape[1]) for A in A_list]
    B = v.shape[-1]
    x = v.reshape(*ms, B)
    # Contract the LAST dimension first (unbatched matmul), then fold remaining
    # dimensions with the data index batched — peak memory O(n · m/m_d · B)
    # rather than O(n · m · B).
    x = jnp.einsum("nm,...mb->n...b", A_list[-1], x, precision=precision)
    for A in reversed(A_list[:-1]):
        x = jnp.einsum("nm,n...mb->n...b", A, x, precision=precision)
    return x[:, 0] if squeeze else x


def kr_rmatvec(
    A_list: Sequence[jax.Array],
    u: jax.Array,
    *,
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Transpose product ``KR(A)ᵀ @ u``: ``(n,)/(n,B) -> (Π m_d,)/(Π m_d, B)``.

    ``(KRᵀu)[j] = Σ_i u[i] Π_d A_d[i, j_d]`` — built as an outer-product chain
    over dimensions with the data index contracted last.
    """
    squeeze = u.ndim == 1
    if squeeze:
        u = u[:, None]
    # Accumulate t[i, j_1..j_k, B] = u[i,B] * Π_{d<k} A_d[i, j_d] for all but
    # the final dimension, then contract the data index i against the final
    # factor as one matmul — peak memory O(n · m/m_d · B).
    t = u[:, None, :] * A_list[0][:, :, None]  # (n, m_1, B)
    for A in A_list[1:-1]:
        n, _, B = t.shape[0], t.shape[1:-1], t.shape[-1]
        t = t.reshape(n, -1, 1, B) * A[:, None, :, None]
        t = t.reshape(n, -1, B)
    if len(A_list) > 1:
        out = jnp.einsum(
            "nrb,nm->rmb", t, A_list[-1], precision=precision
        ).reshape(-1, t.shape[-1])
    else:
        out = jnp.sum(t, axis=0)
    return out[:, 0] if squeeze else out


def rowcol_kr_expand(B_list: Sequence[jax.Array], idx: jax.Array) -> jax.Array:
    """Densify ``Φ[i, j] = Π_d B_d[i, idx[j, d]]`` to an ``(n, p)`` array.

    The reference expands its ``RowColKhatriRaoMatrix`` the same way when ``p``
    is modest (SURVEY.md §3.1 "expand to dense n×p").  Cost ``O(n·p·d)``; the
    per-dimension gather ``B_d[:, idx[:, d]]`` and multiply fuse under XLA.
    """
    n = B_list[0].shape[0]
    p = idx.shape[0]
    out = jnp.ones((n, p), dtype=B_list[0].dtype)
    for d, Bd in enumerate(B_list):
        out = out * jnp.take(Bd, idx[:, d], axis=1)
    return out


def rowcol_kr_matvec(
    B_list: Sequence[jax.Array],
    idx: jax.Array,
    v: jax.Array,
) -> jax.Array:
    """``Φ @ v`` without expanding ``Φ`` (lazy path for very large ``p``)."""
    n = B_list[0].shape[0]
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    acc = jnp.ones((n, idx.shape[0]), dtype=B_list[0].dtype)
    for d, Bd in enumerate(B_list):
        acc = acc * jnp.take(Bd, idx[:, d], axis=1)
    out = acc @ v
    return out[:, 0] if squeeze else out


def rowcol_kr_rmatvec(
    B_list: Sequence[jax.Array],
    idx: jax.Array,
    u: jax.Array,
) -> jax.Array:
    """``Φᵀ @ u`` without expanding ``Φ``."""
    squeeze = u.ndim == 1
    if squeeze:
        u = u[:, None]
    acc = jnp.ones((B_list[0].shape[0], idx.shape[0]), dtype=B_list[0].dtype)
    for d, Bd in enumerate(B_list):
        acc = acc * jnp.take(Bd, idx[:, d], axis=1)
    out = acc.T @ u
    return out[:, 0] if squeeze else out
