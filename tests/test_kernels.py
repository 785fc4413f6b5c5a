"""Kernel tests: closed-form values, PSD-ness, grid factorization, and the
GRIEF basis reproducing the Nyström / exact grid kernel (SURVEY.md §4:
"GriefKernel with p = m reproduces the full Nyström/grid kernel")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax.grid import InducingGrid
from gp_grief_jax.kernels import (
    build_basis,
    cov,
    cov_grid,
    cross_cov_grid,
    make_kernel,
    phi,
    product_cov,
)
from gp_grief_jax.ops import kron_expand, kr_expand


def test_rbf_closed_form(rng):
    k = make_kernel("rbf", lengthscale=2.0, variance=1.5)
    x = rng.standard_normal((5, 3))
    z = rng.standard_normal((4, 3))
    K = np.asarray(cov(k, jnp.asarray(x), jnp.asarray(z)))
    r2 = ((x[:, None, :] - z[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(K, 1.5 * np.exp(-0.5 * r2 / 4.0), rtol=1e-10)


@pytest.mark.parametrize("kind", ["rbf", "exponential", "matern12", "matern32", "matern52"])
def test_kernels_psd_and_symmetric(rng, kind):
    k = make_kernel(kind, lengthscale=0.7, variance=2.0)
    x = jnp.asarray(rng.standard_normal((20, 2)))
    K = np.asarray(cov(k, x))
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    np.testing.assert_allclose(np.diag(K), 2.0, rtol=1e-12)
    w = np.linalg.eigvalsh(K)
    assert w.min() > -1e-10


@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52"])
def test_matern_closed_form_1d(rng, kind):
    ell, var = 0.9, 1.3
    k = make_kernel(kind, lengthscale=ell, variance=var)
    x = np.sort(rng.standard_normal(6))
    K = np.asarray(cov(k, jnp.asarray(x)))
    r = np.abs(x[:, None] - x[None, :]) / ell
    if kind == "matern12":
        ref = var * np.exp(-r)
    elif kind == "matern32":
        ref = var * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)
    else:
        ref = var * (1 + np.sqrt(5) * r + 5 * r**2 / 3) * np.exp(-np.sqrt(5) * r)
    np.testing.assert_allclose(K, ref, rtol=1e-10)


def test_kernel_gradients_flow(rng):
    k = make_kernel("matern52", lengthscale=1.0, variance=1.0)
    x = jnp.asarray(rng.standard_normal((8, 1)))

    def f(kern):
        return jnp.sum(cov(kern, x))

    g = jax.grad(f)(k)
    assert np.isfinite(float(g.log_lengthscale))
    assert np.isfinite(float(g.log_variance))
    assert float(jnp.abs(g.log_lengthscale)) > 0


def test_cov_grid_matches_product_kernel(rng):
    # GridKernel.cov_grid(...).expand() equals the direct product-kernel Gram
    # on the grid (the reference's own kernel test, SURVEY.md §4).
    kerns = [
        make_kernel("rbf", lengthscale=0.5),
        make_kernel("matern32", lengthscale=1.2),
    ]
    xg = [jnp.asarray(np.linspace(0, 1, 4)[:, None]), jnp.asarray(np.linspace(-1, 1, 3)[:, None])]
    factors = cov_grid(kerns, xg)
    K_kron = np.asarray(kron_expand(factors))
    # Full grid as scattered points (C-order lattice).
    g0, g1 = np.asarray(xg[0])[:, 0], np.asarray(xg[1])[:, 0]
    pts = np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2)
    K_dense = np.asarray(product_cov(kerns, jnp.asarray(pts)))
    np.testing.assert_allclose(K_kron, K_dense, rtol=1e-9, atol=1e-12)


def test_cross_cov_grid_khatri_rao(rng):
    kerns = [make_kernel("rbf"), make_kernel("rbf")]
    xg = [jnp.asarray(np.linspace(0, 1, 4)[:, None]), jnp.asarray(np.linspace(0, 1, 3)[:, None])]
    x = jnp.asarray(rng.uniform(0, 1, size=(6, 2)))
    Kx = cross_cov_grid(kerns, x, xg)
    KR = np.asarray(kr_expand(list(Kx)))
    g0, g1 = np.asarray(xg[0])[:, 0], np.asarray(xg[1])[:, 0]
    pts = np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2)
    ref = np.asarray(product_cov(kerns, x, jnp.asarray(pts)))
    np.testing.assert_allclose(KR, ref, rtol=1e-9, atol=1e-12)


def test_grief_full_basis_reproduces_grid_kernel(rng):
    # With p = m and on-grid x, Phi Phi^T == Nystrom == exact K_xx.
    kerns = [make_kernel("rbf", lengthscale=0.8), make_kernel("matern52", lengthscale=1.1)]
    xg = [jnp.asarray(np.linspace(0, 1, 5)[:, None]), jnp.asarray(np.linspace(0, 2, 4)[:, None])]
    g0, g1 = np.asarray(xg[0])[:, 0], np.asarray(xg[1])[:, 0]
    pts = jnp.asarray(np.stack(np.meshgrid(g0, g1, indexing="ij"), -1).reshape(-1, 2))
    m = 20
    basis = build_basis(kerns, xg, p=m, dim_noise_var=0.0)
    Phi = np.asarray(phi(basis, kerns, xg, pts))
    K_exact = np.asarray(product_cov(kerns, pts))
    np.testing.assert_allclose(Phi @ Phi.T, K_exact, rtol=1e-7, atol=1e-9)


def test_grief_truncated_basis_approximates(rng):
    # Truncated p < m should approximate the kernel with spectral-decay error.
    kern = make_kernel("rbf", lengthscale=0.5)
    xg = [jnp.asarray(np.linspace(0, 1, 30)[:, None])]
    x = jnp.asarray(rng.uniform(0, 1, size=(50, 1)))
    K_exact = np.asarray(cov(kern, x))
    errs = []
    for p in (3, 10, 25):
        basis = build_basis([kern], xg, p=p)
        Phi = np.asarray(phi(basis, [kern], xg, x))
        errs.append(np.abs(Phi @ Phi.T - K_exact).max())
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-5


def test_grief_basis_jit_and_grad(rng):
    kern = make_kernel("rbf", lengthscale=0.5)
    xg = [jnp.asarray(np.linspace(0, 1, 12)[:, None])]
    x = jnp.asarray(rng.uniform(0, 1, size=(9, 1)))

    @jax.jit
    def feat_sum(k):
        basis = build_basis([k], xg, p=6, dim_noise_var=1e-10)
        return jnp.sum(phi(basis, [k], xg, x) ** 2)

    val = feat_sum(kern)
    g = jax.grad(feat_sum)(kern)
    assert np.isfinite(float(val))
    assert np.isfinite(float(g.log_lengthscale))


def test_inducing_grid_modes(rng):
    x = rng.standard_normal((200, 3))
    x[:, 2] = rng.integers(0, 4, size=200)  # few unique values in dim 2
    g = InducingGrid.build(x, mbar=8)
    assert g.grid_shape == (8, 8, 4)  # dim 2 keeps its 4 unique values
    assert g.input_dim == 3 and g.num_data == 200
    g_km = InducingGrid.build(x, mbar=8, eq=False)
    assert g_km.grid_shape[0] == 8
    # kmeans centers lie inside the data range
    assert g_km.xg[0].min() >= x[:, 0].min() and g_km.xg[0].max() <= x[:, 0].max()
    # log10 virtual count sane
    big = InducingGrid.build(rng.standard_normal((50, 100)), mbar=10)
    assert big.log10_num_virtual == pytest.approx(100.0)


def test_inducing_grid_grouped_dims(rng):
    # The reference's sub_dim capability: grid dims spanning multiple columns.
    x = rng.standard_normal((300, 4))
    g = InducingGrid.build(x, mbar=[8, 25], dims=[[0], [1, 2, 3]])
    assert g.grid_dim == 2
    assert g.xg[0].shape[1] == 1 and g.xg[1].shape == (25, 3)
    assert g.dims == ((0,), (1, 2, 3))


def test_grief_model_grouped_dims(rng):
    from gp_grief_jax import GPGriefModel

    n = 120
    x = rng.uniform(0, 1, size=(n, 3))
    y = np.sin(4 * x[:, 0]) + 0.5 * x[:, 1] * x[:, 2] + 0.03 * rng.standard_normal(n)
    grid = InducingGrid.build(x, mbar=[12, 30], dims=[[0], [1, 2]])
    kerns = [make_kernel("rbf", lengthscale=0.4), make_kernel("rbf", lengthscale=0.6, input_dim=2)]
    model = GPGriefModel(x, y, kerns, grid, n_eigs=25, noise_var=0.2)
    assert np.isfinite(model.log_likelihood())
    model.optimize(max_iters=40)
    mean, var = model.predict(x[:15])
    rmse = float(np.sqrt(np.mean((mean - (np.sin(4 * x[:15, 0]) + 0.5 * x[:15, 1] * x[:15, 2])) ** 2)))
    assert rmse < 0.2 and np.all(var >= 0)
