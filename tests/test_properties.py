"""Property-based tests (hypothesis) over the structured tensor algebra —
randomized shapes/seeds beyond the fixed-seed oracle tests (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings, strategies as st

from gp_grief_jax.ops import (
    kr_expand,
    kr_matvec,
    kron_expand,
    kron_matvec,
    kron_matvec_fast,
    top_p_kron_eigs,
)

_sizes = st.lists(st.integers(min_value=1, max_value=5), min_size=1, max_size=4)


@settings(max_examples=25, deadline=None)
@given(sizes=_sizes, seed=st.integers(0, 2**31 - 1))
def test_kron_matvec_property(sizes, seed):
    rng = np.random.default_rng(seed)
    fs = tuple(jnp.asarray(rng.standard_normal((m, m))) for m in sizes)
    K = np.asarray(kron_expand(fs))
    v = rng.standard_normal(K.shape[1])
    np.testing.assert_allclose(
        np.asarray(kron_matvec(fs, jnp.asarray(v))), K @ v, rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(kron_matvec_fast(fs, jnp.asarray(v), target_width=6)),
        K @ v,
        rtol=1e-8,
        atol=1e-10,
    )


@settings(max_examples=20, deadline=None)
@given(sizes=_sizes, n=st.integers(1, 6), seed=st.integers(0, 2**31 - 1))
def test_khatri_rao_property(sizes, n, seed):
    rng = np.random.default_rng(seed)
    A = [jnp.asarray(rng.standard_normal((n, m))) for m in sizes]
    KR = np.asarray(kr_expand(A))
    v = rng.standard_normal(KR.shape[1])
    np.testing.assert_allclose(
        np.asarray(kr_matvec(A, jnp.asarray(v))), KR @ v, rtol=1e-8, atol=1e-10
    )


@settings(max_examples=20, deadline=None)
@given(
    sizes=st.lists(st.integers(2, 5), min_size=1, max_size=4),
    p=st.integers(1, 12),
    seed=st.integers(0, 2**31 - 1),
)
def test_top_p_property(sizes, p, seed):
    rng = np.random.default_rng(seed)
    lams = [jnp.asarray(rng.uniform(1e-3, 1e3, size=m)) for m in sizes]
    log_lam, idx = top_p_kron_eigs(lams, p)
    full = np.asarray(lams[0])
    for lam in lams[1:]:
        full = np.outer(full, np.asarray(lam)).ravel()
    k = min(p, full.size)
    ref = np.sort(np.log(full))[::-1][:k]
    np.testing.assert_allclose(np.asarray(log_lam)[:k], ref, rtol=1e-10)
    # Index table consistency.
    recon = np.zeros(k)
    for j in range(k):
        recon[j] = sum(np.log(np.asarray(lams[d])[int(idx[j, d])]) for d in range(len(sizes)))
    np.testing.assert_allclose(np.asarray(log_lam)[:k], recon, rtol=1e-10)
