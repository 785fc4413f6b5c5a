"""Grouped cyclic Kron matvec (the one XLA chain that serves every Kron
matvec) and the Φ assemblies vs float64 oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from gp_grief_jax.ops import kron_expand
from gp_grief_jax.ops.kron_fast import group_factors, kron_matvec_fast


def _kron_oracle(factors, v):
    """Exact f64 ``(⊗K_d) v`` by per-axis contraction; ``v`` (M,) or (M, B)."""
    fs = [np.asarray(K, np.float64) for K in factors]
    v = np.asarray(v, np.float64)
    squeeze = v.ndim == 1
    V = v[:, None] if squeeze else v
    x = V.reshape(*[K.shape[1] for K in fs], V.shape[1])
    for i, K in enumerate(fs):
        x = np.moveaxis(np.tensordot(K, x, axes=(1, i)), 0, i)
    out = x.reshape(-1, V.shape[1])
    return out[:, 0] if squeeze else out


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("sizes", [(3,), (3, 4), (2, 3, 4), (4, 4, 4, 4), (5, 5, 5)])
def test_kron_matvec_fast_matches_dense(rng, sizes):
    factors = tuple(jnp.asarray(rng.standard_normal((m, m))) for m in sizes)
    K = np.asarray(kron_expand(factors))
    v = rng.standard_normal(K.shape[1])
    got = kron_matvec_fast(factors, jnp.asarray(v), target_width=8, precision=None)
    np.testing.assert_allclose(np.asarray(got), K @ v, rtol=1e-9)


def test_kron_matvec_fast_batched(rng):
    sizes = (3, 4, 2)
    factors = tuple(jnp.asarray(rng.standard_normal((m, m))) for m in sizes)
    K = np.asarray(kron_expand(factors))
    V = rng.standard_normal((K.shape[1], 5))
    got = kron_matvec_fast(factors, jnp.asarray(V), target_width=8)
    np.testing.assert_allclose(np.asarray(got), K @ V, rtol=1e-9)


def test_group_factors_widths(rng):
    fs = [jnp.asarray(rng.standard_normal((8, 8))) for _ in range(4)]
    gf = group_factors(fs, target_width=64, max_width=64)
    assert [int(g.shape[0]) for g in gf] == [64, 64]
    # Grouped product equals the full product.
    np.testing.assert_allclose(
        np.asarray(kron_expand(gf)), np.asarray(kron_expand(fs)), rtol=1e-12
    )
    # Rectangular factors break groups.
    fs2 = [fs[0], jnp.asarray(rng.standard_normal((3, 8))), fs[1]]
    gf2 = group_factors(fs2, target_width=64)
    assert [g.shape for g in gf2] == [(8, 8), (3, 8), (8, 8)]


def test_kron_matvec_fast_dispatch_gate(rng):
    """One path on every backend: no implementation switch is left, and the
    DEFAULT-precision chain agrees with HIGHEST (exact on the CPU; within
    TF32 rounding on a GPU)."""
    sizes = (4, 4, 8, 8, 8)
    factors = tuple(jnp.asarray(rng.standard_normal((m, m))) for m in sizes)
    v = jnp.asarray(rng.standard_normal(int(np.prod(sizes))))
    fast = kron_matvec_fast(factors, v, precision=lax.Precision.DEFAULT, target_width=64)
    exact = kron_matvec_fast(factors, v, precision=lax.Precision.HIGHEST, target_width=64)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(exact), rtol=1e-12)
    with pytest.raises(TypeError):
        kron_matvec_fast(factors, v, impl="xla")


@pytest.mark.parametrize(
    "precision,passes", [(lax.Precision.HIGHEST, 4), (lax.Precision.DEFAULT, 2)]
)
def test_kron_matvec_fast_default_width_follows_precision(rng, precision, passes):
    """Without ``target_width`` the group width comes from GROUP_WIDTH: 16⁴
    stays four 16-wide passes at HIGHEST and becomes two 256-wide passes at
    DEFAULT (a third merge would pass 1024); both equal the oracle."""
    from gp_grief_jax.ops.kron_fast import GROUP_WIDTH

    assert GROUP_WIDTH == {"exact": 64, "fast": 1024}
    sizes = (16, 16, 16, 16)
    factors = tuple(jnp.asarray(rng.standard_normal((m, m)) / 4.0) for m in sizes)
    v = jnp.asarray(rng.standard_normal(16**4))
    fn = lambda fs, x: kron_matvec_fast(fs, x, precision=precision)  # noqa: E731
    eqns = jax.make_jaxpr(fn)(factors, v).jaxpr.eqns
    assert sum(e.primitive.name == "dot_general" for e in eqns) == passes
    assert _rel(fn(factors, v), _kron_oracle(factors, v)) < 1e-12


def test_kron_matvec_fast_rectangular(rng):
    factors = (
        jnp.asarray(rng.standard_normal((4, 3))),
        jnp.asarray(rng.standard_normal((5, 5))),
        jnp.asarray(rng.standard_normal((2, 6))),
    )
    K = np.asarray(kron_expand(factors))
    v = rng.standard_normal(K.shape[1])
    got = kron_matvec_fast(factors, jnp.asarray(v), target_width=8)
    np.testing.assert_allclose(np.asarray(got), K @ v, rtol=1e-9)


# Shapes the removed fused and slab schedules served, now on the chain.
_MATMAT = [
    ((4, 4, 4), 1), ((8, 4, 2), 1), ((2, 2, 2, 2, 2), 1),
    ((16, 16), 1), ((4, 4, 4), 5), ((8, 8), 3),
]
_SLAB = [((4, 4, 8, 8, 8), 1), ((4, 4, 8, 8, 8), 4)]
_GENERAL = [
    ((12, 24, 96), 1),  # ragged d=3
    ((8, 12, 24, 96), 1),  # ragged d=4
    ((96, 128), 1),  # d=2
    ((20, 28, 96), 1),  # fully ragged
    ((20, 20, 100), 1),  # lane width not a multiple of 128
]


@pytest.mark.parametrize("sizes,B", _MATMAT + _SLAB + _GENERAL)
def test_kron_matvec_fast_shapes_match_oracle(rng, sizes, B):
    factors = tuple(
        jnp.asarray(rng.standard_normal((m, m)) / np.sqrt(m)) for m in sizes
    )
    m = int(np.prod(sizes))
    v = rng.standard_normal((m, B)) if B > 1 else rng.standard_normal(m)
    got = kron_matvec_fast(factors, jnp.asarray(v))
    assert got.shape == v.shape
    assert _rel(got, _kron_oracle(factors, v)) < 1e-12


def test_kron_matvec_fast_leading_identity_batch(rng):
    """The solvers' batch-major form ``(I_B ⊗ K) vec(V)``."""
    sizes = (12, 24, 96)
    factors = (jnp.eye(8),) + tuple(
        jnp.asarray(rng.standard_normal((m, m)) / np.sqrt(m)) for m in sizes
    )
    v = rng.standard_normal(8 * int(np.prod(sizes)))
    got = kron_matvec_fast(factors, jnp.asarray(v))
    assert _rel(got, _kron_oracle(factors, v)) < 1e-12


def test_kron_matvec_fast_d6_wide_pair(rng):
    sizes = (4, 4, 4, 4, 16, 16)
    factors = tuple(
        jnp.asarray(rng.standard_normal((m, m)) / np.sqrt(m)) for m in sizes
    )
    v = rng.standard_normal(int(np.prod(sizes)))
    got = kron_matvec_fast(factors, jnp.asarray(v), target_width=256)
    assert _rel(got, _kron_oracle(factors, v)) < 1e-12


def test_kron_matvec_fast_rectangular_oracle(rng):
    factors = (
        jnp.asarray(rng.standard_normal((6, 4))),
        jnp.asarray(rng.standard_normal((3, 8))),
    )
    v = rng.standard_normal((32, 2))
    got = kron_matvec_fast(factors, jnp.asarray(v))
    assert got.shape == (18, 2)
    assert _rel(got, _kron_oracle(factors, v)) < 1e-12


def test_kron_matvec_fast_bf16_input(rng):
    """A bf16 vector (mixed16 solver state) runs the chain in bf16."""
    sizes = (12, 24, 96)
    factors = tuple(
        jnp.asarray(rng.standard_normal((m, m)) / np.sqrt(m), jnp.float32)
        for m in sizes
    )
    v = rng.standard_normal(int(np.prod(sizes)))
    got = kron_matvec_fast(factors, jnp.asarray(v, jnp.bfloat16))
    assert got.dtype == jnp.bfloat16
    assert _rel(got, _kron_oracle(factors, v)) < 5e-2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kron_matvec_fast_fuzz(seed):
    """Random square and rectangular shapes, grouped and ungrouped."""
    rng = np.random.default_rng(seed)
    for trial in range(4):
        d = int(rng.integers(2, 5))
        sizes = [int(rng.choice([4, 8, 12, 16, 24, 32, 48, 96, 100]))
                 for _ in range(d)]
        while np.prod(sizes) > 200_000:
            sizes[int(np.argmax(sizes))] //= 2
        outs = (
            [int(rng.choice([8, 16, 32, 96])) for _ in sizes]
            if trial % 2
            else list(sizes)
        )
        factors = tuple(
            jnp.asarray(rng.standard_normal((o, m)) / np.sqrt(m))
            for o, m in zip(outs, sizes)
        )
        v = rng.standard_normal(int(np.prod(sizes)))
        tw = int(rng.choice([1, 128, 1024]))
        got = kron_matvec_fast(factors, jnp.asarray(v), target_width=tw)
        assert _rel(got, _kron_oracle(factors, v)) < 1e-12, (sizes, outs, tw)


@pytest.mark.parametrize("sizes", [(4, 3, 5), (12, 24, 96)])
def test_kron_matvec_fast_grad(rng, sizes):
    """Gradients in the factors and the vector match the dense f64 form."""
    factors = tuple(
        jnp.asarray(rng.standard_normal((m, m)) / np.sqrt(m)) for m in sizes
    )
    m = int(np.prod(sizes))
    V = jnp.asarray(rng.standard_normal((m, 2)))
    G = jnp.asarray(rng.standard_normal((m, 2)))

    def loss(fs, V):
        return jnp.sum(kron_matvec_fast(fs, V) * G)

    gf, gv = jax.grad(loss, argnums=(0, 1))(factors, V)
    # d/dV <(⊗K)V, G> = (⊗K)ᵀ G ; d/dK_d by the chain through the oracle.
    ref_v = _kron_oracle(tuple(K.T for K in factors), G)
    assert _rel(gv, ref_v) < 1e-12
    if m <= 64:
        def loss_dense(fs, V):
            return jnp.sum((kron_expand(fs) @ V) * G)

        gf_ref = jax.grad(loss_dense)(factors, V)
        for a, b in zip(gf, gf_ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)
    else:
        eps = 1e-6
        dK = jnp.asarray(rng.standard_normal(factors[1].shape))
        fp = (factors[0], factors[1] + eps * dK, factors[2])
        fm = (factors[0], factors[1] - eps * dK, factors[2])
        fd = (float(loss(fp, V)) - float(loss(fm, V))) / (2 * eps)
        np.testing.assert_allclose(float(jnp.sum(gf[1] * dK)), fd, rtol=1e-6)


def _phi_case(rng, d=3, n=32, m=8, p=16):
    from gp_grief_jax import make_kernel
    from gp_grief_jax.kernels.grief import build_basis

    xg = tuple(jnp.asarray(np.linspace(0, 1, m)[:, None]) for _ in range(d))
    kerns = [make_kernel("rbf", lengthscale=0.3 + 0.1 * i) for i in range(d)]
    x = jnp.asarray(rng.uniform(0, 1, (n, d)))
    basis = build_basis(kerns, xg, p, dim_noise_var=1e-8)
    return basis, kerns, xg, x


def _phi_oracle(basis, kerns, xg, x):
    """Φ[i, j] = Π_d (K_xU_d Q_d)[i, idx_jd] λ_{d, idx_jd}^{-1/2}, in numpy."""
    out = None
    for dd, (k, g) in enumerate(zip(kerns, xg)):
        Kx = np.asarray(k(x[:, dd : dd + 1], g), np.float64)
        B = Kx @ np.asarray(basis.Qs[dd], np.float64)
        cols = np.asarray(basis.idx[:, dd])
        G = B[:, cols] / np.sqrt(np.asarray(basis.lams[dd], np.float64)[cols])
        out = G if out is None else out * G
    return out


@pytest.mark.parametrize("impl", ["batched", "xla"])
def test_phi_assemblies_match_oracle(rng, impl):
    from gp_grief_jax.kernels.grief import phi

    basis, kerns, xg, x = _phi_case(rng)
    got = phi(basis, kerns, xg, x, impl=impl)
    np.testing.assert_allclose(
        np.asarray(got), _phi_oracle(basis, kerns, xg, x), rtol=1e-9, atol=1e-12
    )


@pytest.mark.parametrize("impl", ["batched", "xla"])
def test_phi_assemblies_grad(rng, impl):
    """Gradient in the kernel hyperparameters through basis + Φ agrees
    between the two assemblies and with central differences."""
    from gp_grief_jax.kernels.grief import build_basis, phi

    _, kerns, xg, x = _phi_case(rng, n=16)
    G = jnp.asarray(rng.standard_normal((16, 16)))

    def loss(ks, impl):
        b = build_basis(ks, xg, 16, dim_noise_var=1e-8)
        return jnp.sum(phi(b, ks, xg, x, impl=impl) * G)

    g = jax.grad(loss)(kerns, impl)
    g_other = jax.grad(loss)(kerns, "xla" if impl == "batched" else "batched")
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_other)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-7, atol=1e-10)
    eps = 1e-6
    leaf = jax.tree.leaves(kerns[0])[0]
    bump = lambda e: [jax.tree.map(lambda l: l + e if l is leaf else l, kerns[0])] + kerns[1:]  # noqa: E731
    fd = (float(loss(bump(eps), impl)) - float(loss(bump(-eps), impl))) / (2 * eps)
    np.testing.assert_allclose(float(jax.tree.leaves(g[0])[0]), fd, rtol=1e-5, atol=1e-8)
