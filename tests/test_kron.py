"""Dense-oracle tests for Kronecker ops — mirrors the reference test style:
every structured result is checked against ``expand()`` ground truth
(SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.ops import (
    kron_chol,
    kron_diag,
    kron_eigh,
    kron_expand,
    kron_logdet_from_chol,
    kron_logdet_from_eigs,
    kron_matvec,
    kron_shapes,
    kron_solve_schur,
)


def _random_spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _random_factors(rng, sizes):
    return tuple(jnp.asarray(_random_spd(rng, s)) for s in sizes)


@pytest.mark.parametrize("sizes", [(3,), (3, 4), (2, 3, 4), (5, 5, 5)])
def test_kron_matvec_matches_dense(rng, sizes):
    factors = _random_factors(rng, sizes)
    K = np.asarray(kron_expand(factors))
    m = K.shape[1]
    v = rng.standard_normal(m)
    np.testing.assert_allclose(kron_matvec(factors, jnp.asarray(v)), K @ v, rtol=1e-10)


def test_kron_matvec_rectangular_and_batched(rng):
    # Rectangular factors (q_d != m_d) and a batched rhs.
    factors = tuple(
        jnp.asarray(rng.standard_normal((q, m))) for q, m in [(4, 3), (2, 5)]
    )
    K = np.asarray(kron_expand(factors))
    assert kron_shapes(factors) == K.shape
    V = rng.standard_normal((K.shape[1], 7))
    np.testing.assert_allclose(kron_matvec(factors, jnp.asarray(V)), K @ V, rtol=1e-10)


def test_kron_diag(rng):
    factors = _random_factors(rng, (3, 4, 2))
    K = np.asarray(kron_expand(factors))
    np.testing.assert_allclose(kron_diag(factors), np.diag(K), rtol=1e-12)


@pytest.mark.parametrize("sizes", [(4, 4, 4), (3, 5)])
def test_kron_eigh_reconstructs(rng, sizes):
    factors = _random_factors(rng, sizes)
    Qs, lams = kron_eigh(factors)
    for K, Q, lam in zip(factors, Qs, lams):
        np.testing.assert_allclose(
            np.asarray(Q) * np.asarray(lam) @ np.asarray(Q).T,
            np.asarray(K),
            rtol=1e-8,
            atol=1e-8,
        )


def test_kron_chol_and_logdet(rng):
    factors = _random_factors(rng, (3, 4))
    K = np.asarray(kron_expand(factors))
    Ls = kron_chol(factors)
    L_dense = np.asarray(kron_expand(Ls))
    np.testing.assert_allclose(L_dense @ L_dense.T, K, rtol=1e-9)
    _, ref_logdet = np.linalg.slogdet(K)
    np.testing.assert_allclose(kron_logdet_from_chol(Ls), ref_logdet, rtol=1e-10)
    _, lams = kron_eigh(factors)
    np.testing.assert_allclose(kron_logdet_from_eigs(lams), ref_logdet, rtol=1e-10)


def test_kron_solve_schur(rng):
    factors = _random_factors(rng, (3, 4, 2))
    K = np.asarray(kron_expand(factors))
    shift = 0.7
    b = rng.standard_normal(K.shape[0])
    Qs, lams = kron_eigh(factors)
    x = kron_solve_schur(Qs, lams, jnp.asarray(b), shift)
    ref = np.linalg.solve(K + shift * np.eye(K.shape[0]), b)
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-10)
    # Batched rhs
    B = rng.standard_normal((K.shape[0], 3))
    X = kron_solve_schur(Qs, lams, jnp.asarray(B), shift)
    np.testing.assert_allclose(
        X, np.linalg.solve(K + shift * np.eye(K.shape[0]), B), rtol=1e-8, atol=1e-10
    )
