"""Top-p Kronecker eigenvalue selection vs. brute-force oracle, plus the
d=100 / 10^100-virtual-point stress shape (BASELINE.json config 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.ops import kron_expand, top_p_kron_eigs


@pytest.mark.parametrize("sizes,p", [((5,), 3), ((3, 4), 6), ((2, 3, 4), 10), ((3, 3), 9)])
def test_top_p_matches_bruteforce(rng, sizes, p):
    lams = [jnp.asarray(rng.uniform(0.1, 10.0, size=m)) for m in sizes]
    log_lam, idx = top_p_kron_eigs(lams, p)
    # Brute force: all products, sorted descending.
    full = np.asarray(lams[0])
    for lam in lams[1:]:
        full = np.outer(full, np.asarray(lam)).ravel()
    ref = np.sort(np.log(full))[::-1][:p]
    np.testing.assert_allclose(np.asarray(log_lam), ref, rtol=1e-12)
    # Index table reconstructs the selected values.
    recon = np.zeros(p)
    for j in range(p):
        recon[j] = sum(
            np.log(np.asarray(lams[d])[int(idx[j, d])]) for d in range(len(sizes))
        )
    np.testing.assert_allclose(np.asarray(log_lam), recon, rtol=1e-12)


def test_top_p_matches_dense_eigh(rng):
    # Against eigvalsh of the expanded Kronecker matrix (the reference's own
    # oracle, SURVEY.md §4).
    def spd(n):
        A = rng.standard_normal((n, n))
        return jnp.asarray(A @ A.T + n * np.eye(n))

    factors = (spd(3), spd(4))
    lams = [jnp.linalg.eigvalsh(f) for f in factors]
    log_lam, _ = top_p_kron_eigs(lams, 5)
    dense_eigs = np.linalg.eigvalsh(np.asarray(kron_expand(factors)))
    ref = np.sort(np.log(dense_eigs))[::-1][:5]
    np.testing.assert_allclose(np.asarray(log_lam), ref, rtol=1e-9)


def test_top_p_p_exceeds_lattice(rng):
    lams = [jnp.asarray(rng.uniform(0.5, 2.0, size=2)) for _ in range(2)]
    log_lam, idx = top_p_kron_eigs(lams, 10)  # lattice has only 4 points
    assert log_lam.shape == (10,)
    assert np.all(np.isfinite(np.asarray(log_lam)[:4]))
    assert np.all(np.asarray(log_lam)[4:] == -np.inf)


def test_top_p_d100_stress(rng):
    # d=100, m_d=10 → 10^100 virtual eigenvalues; select top 500 in log-space.
    d, m_d, p = 100, 10, 500
    lams = [jnp.asarray(rng.uniform(1e-6, 1e3, size=m_d)) for _ in range(d)]
    fn = jax.jit(lambda ls: top_p_kron_eigs(ls, p))
    log_lam, idx = fn(lams)
    log_lam = np.asarray(log_lam)
    assert log_lam.shape == (p,)
    assert idx.shape == (p, d)
    # Sorted descending, finite, and the top-1 equals the per-dim max sum.
    assert np.all(np.diff(log_lam) <= 1e-9)
    assert np.all(np.isfinite(log_lam))
    best = sum(float(jnp.log(jnp.max(l))) for l in lams)
    np.testing.assert_allclose(log_lam[0], best, rtol=1e-12)
    # Selected tuples must be unique.
    tuples = {tuple(np.asarray(idx)[j]) for j in range(p)}
    assert len(tuples) == p
