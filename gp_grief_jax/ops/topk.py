"""Top-p eigenvalue selection for Kronecker products, in log-space.

The GRIEF basis needs the ``p`` largest eigenvalues of ``K_UU = ⊗_d K_d``
without materializing all ``m = Π m_d`` of them (``m`` can exceed ``10^100``).
Each Kronecker eigenvalue is a product ``Π_d λ_d[i_d]`` over one index per
dimension, so in log-space we need the ``p`` largest sums ``Σ_d log λ_d[i_d]``.

The reference does this with a host-side search (reference:
``gp_grief/tensors.py``, the ``KronMatrix`` top-p eigenvalue selection —
SURVEY.md §2 #1, §7 hard-part 2).  Here we use an **exact incremental fold**
that is fully jittable with static shapes:

    keep the top-p partial sums over dims ``1..k``; folding in dim ``k+1``
    forms the ``p × m_{k+1}`` outer sums and re-selects the top p.

Exactness: if a full sum's prefix (dims ``1..k``) were *not* among the top-p
prefixes, then each of the ≥p larger prefixes combined with the same suffix
index would beat it — so the true top-p full sums always have top-p prefixes.
Cost ``O(Σ_d p·m_d)``; for the d=100 stress config this is ~10⁵ work instead of
10¹⁰⁰.  Everything is `lax.top_k` + gathers: on the device, no host round-trip.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["top_p_kron_eigs"]


def top_p_kron_eigs(
    lams: Sequence[jax.Array],
    p: int,
    *,
    min_eig: float | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Select the ``p`` largest Kronecker eigenvalue products in log-space.

    Args:
      lams: per-dimension eigenvalue vectors ``λ_d`` of shape ``(m_d,)``
        (any order, assumed ≥ 0 up to round-off; clipped at ``min_eig``).
      p: number of eigenvalues to keep.  Must satisfy ``p ≤ Π m_d``; when the
        product overflows int range the caller guarantees it (it always holds
        for ``p`` up to thousands and ``m_d ≥ 2``).

    Returns:
      ``(log_lam, idx)`` where ``log_lam`` is ``(p,)`` — the selected
      ``log Π_d λ_d[i_d]`` sorted descending — and ``idx`` is ``(p, d)`` int32,
      the per-dimension eigenvalue indices of each selected product (the
      column-selection table used to build the eigenfunction basis Φ,
      reference "row-selection products" [B:5]).
    """
    d = len(lams)
    dtype = jnp.result_type(*[l.dtype for l in lams])
    if min_eig is None:
        min_eig = float(jnp.finfo(dtype).tiny)
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    # Fold dim 1: top min(p, m_1) of log λ_1, padded to p with -inf.
    log0 = jnp.log(jnp.clip(lams[0].astype(dtype), min_eig, None))
    k0 = min(p, int(log0.shape[0]))
    vals, i0 = lax.top_k(log0, k0)
    sums = jnp.full((p,), neg_inf, dtype).at[:k0].set(vals)
    idx = jnp.zeros((p, d), dtype=jnp.int32).at[:k0, 0].set(i0.astype(jnp.int32))

    for dd in range(1, d):
        log_d = jnp.log(jnp.clip(lams[dd].astype(dtype), min_eig, None))
        m_d = int(log_d.shape[0])
        # All p × m_d candidate sums; -inf prefixes (lattice smaller than p,
        # padded at the first fold) stay -inf and sort to the tail.
        cand = sums[:, None] + log_d[None, :]
        flat = cand.reshape(-1)
        new_vals, flat_i = lax.top_k(flat, p)
        prefix_i = (flat_i // m_d).astype(jnp.int32)
        col_i = (flat_i % m_d).astype(jnp.int32)
        idx = jnp.take(idx, prefix_i, axis=0).at[:, dd].set(col_i)
        sums = new_vals
    return sums, idx
