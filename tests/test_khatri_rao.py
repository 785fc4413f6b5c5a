"""Dense-oracle tests for Khatri-Rao and row/col-selected Kronecker ops."""

import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.ops import (
    kr_expand,
    kr_matvec,
    kr_rmatvec,
    rowcol_kr_expand,
    rowcol_kr_matvec,
    rowcol_kr_rmatvec,
    select_rows,
    select_rows_t,
    selection_expand,
)


@pytest.mark.parametrize("sizes", [(4,), (3, 5), (2, 3, 4)])
def test_kr_matvec_matches_dense(rng, sizes):
    n = 6
    A_list = [jnp.asarray(rng.standard_normal((n, m))) for m in sizes]
    KR = np.asarray(kr_expand(A_list))
    assert KR.shape == (n, int(np.prod(sizes)))
    v = rng.standard_normal(KR.shape[1])
    np.testing.assert_allclose(kr_matvec(A_list, jnp.asarray(v)), KR @ v, rtol=1e-10)
    V = rng.standard_normal((KR.shape[1], 3))
    np.testing.assert_allclose(kr_matvec(A_list, jnp.asarray(V)), KR @ V, rtol=1e-10)


@pytest.mark.parametrize("sizes", [(4,), (3, 5), (2, 3, 4)])
def test_kr_rmatvec_matches_dense(rng, sizes):
    n = 6
    A_list = [jnp.asarray(rng.standard_normal((n, m))) for m in sizes]
    KR = np.asarray(kr_expand(A_list))
    u = rng.standard_normal(n)
    np.testing.assert_allclose(kr_rmatvec(A_list, jnp.asarray(u)), KR.T @ u, rtol=1e-10)
    U = rng.standard_normal((n, 2))
    np.testing.assert_allclose(kr_rmatvec(A_list, jnp.asarray(U)), KR.T @ U, rtol=1e-10)


def test_rowcol_kr_ops(rng):
    n, p = 7, 5
    sizes = (3, 4, 2)
    B_list = [jnp.asarray(rng.standard_normal((n, m))) for m in sizes]
    idx = jnp.asarray(
        np.stack([rng.integers(0, m, size=p) for m in sizes], axis=1), dtype=jnp.int32
    )
    Phi = np.asarray(rowcol_kr_expand(B_list, idx))
    # Oracle: entrywise product of gathered columns.
    ref = np.ones((n, p))
    for d, Bd in enumerate(B_list):
        ref *= np.asarray(Bd)[:, np.asarray(idx)[:, d]]
    np.testing.assert_allclose(Phi, ref, rtol=1e-12)

    v = rng.standard_normal(p)
    np.testing.assert_allclose(
        rowcol_kr_matvec(B_list, idx, jnp.asarray(v)), ref @ v, rtol=1e-10
    )
    u = rng.standard_normal(n)
    np.testing.assert_allclose(
        rowcol_kr_rmatvec(B_list, idx, jnp.asarray(u)), ref.T @ u, rtol=1e-10
    )


def test_selection_ops(rng):
    m, k = 8, 3
    idx = jnp.asarray([5, 0, 2])
    x = jnp.asarray(rng.standard_normal((m, 4)))
    S = np.asarray(selection_expand(idx, m))
    np.testing.assert_allclose(select_rows(idx, x), S @ np.asarray(x))
    u = jnp.asarray(rng.standard_normal((k, 4)))
    np.testing.assert_allclose(select_rows_t(idx, u, m), S.T @ np.asarray(u))
