"""ops/fused.py: fused CG+Lanczos segments vs the separate-pass solvers.

Trajectory-level comparisons are only meaningful per-step: CG and Lanczos
amplify single-ulp differences exponentially (finite-precision chaos), so
the equivalence test checks bitwise state equality for a few iterations,
and the long-run tests check the quantities that matter — the converged
solve and the SLQ estimate.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax import lax

from gp_grief_jax.ops.cg import _make_pcg_step, _reducers
from gp_grief_jax.ops.fused import fused_cg_slq_segment, make_fused_cg_lanczos_step
from gp_grief_jax.ops.lanczos import slq_logdet


def _spd(m, seed, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    lam = np.geomspace(1.0, cond, m)
    return (Q * lam) @ Q.T


def test_fused_step_bitwise_matches_pcg_step():
    """Per-iteration state equality against ops.cg._make_pcg_step on a
    row-invariant (diagonal) operator — catches any semantic drift in the
    fused CG arithmetic without rounding-chaos amplification."""
    m, R = 96, 6
    rng = np.random.default_rng(0)
    d = jnp.asarray(np.geomspace(1.0, 300.0, m))
    op = lambda v: v * d[None, :]  # noqa: E731
    b = jnp.asarray(rng.standard_normal((1, m)))
    _colsum, _colnorm, _bc = _reducers("bm", None)
    step = _make_pcg_step(op, lambda rr: rr, _colsum, _bc)
    fstep = make_fused_cg_lanczos_step(op, _colsum, _colnorm, _bc)
    Z = jax.random.rademacher(jax.random.PRNGKey(7), (R, m), dtype=jnp.float64)
    q0 = Z / _bc(_colnorm(Z))
    lz = (q0, jnp.zeros_like(q0), jnp.zeros((R,), jnp.float64), jnp.ones((R,), bool))
    s_sep = (jnp.zeros_like(b), b, b, b, _colsum(b * b), jnp.zeros((1,), bool))
    s_fus = s_sep
    for _ in range(5):
        s_sep = step(*s_sep)
        s_fus, lz, _ = fstep(s_fus, lz)
        for a, f in zip(s_sep, s_fus):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(f))


def test_fused_slq_matches_separate_and_cg_converges():
    m, R, k = 96, 6, 120
    A = jnp.asarray(_spd(m, 0), jnp.float64)
    op = lambda v_bm: v_bm @ A  # noqa: E731  (symmetric)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal((1, m)))
    key = jax.random.PRNGKey(7)

    _colsum, _colnorm, _bc = _reducers("bm", None)
    ld_sep = slq_logdet(
        op, m, key=key, num_probes=R, lanczos_iters=k,
        dtype=jnp.float64, layout="bm",
    )
    cg0 = (jnp.zeros_like(b), b, b, b, _colsum(b * b), jnp.zeros((1,), bool))
    Z = jax.random.rademacher(key, (R, m), dtype=jnp.float64)
    cg_state, ld_fused = fused_cg_slq_segment(op, cg0, Z, k)

    # CG at κ=1e3: linear rate (√κ−1)/(√κ+1) ≈ 0.94 → ~1e-4 after 120 iters
    np.testing.assert_allclose(
        np.asarray(cg_state[0] @ A), np.asarray(b), rtol=1e-4, atol=1e-4
    )
    # same probe draw, same recurrence → same SLQ estimate
    np.testing.assert_allclose(float(ld_fused), float(ld_sep), rtol=1e-8)
    sign, ld_true = np.linalg.slogdet(np.asarray(A))
    assert sign > 0
    assert abs(float(ld_fused) - ld_true) / abs(ld_true) < 0.2


def test_fused_segment_is_jittable_and_resumable():
    m, R, k = 64, 4, 10
    A = jnp.asarray(_spd(m, 3, cond=50.0), jnp.float64)
    op = lambda v_bm: v_bm @ A  # noqa: E731
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.standard_normal((2, m)))  # Bc=2 CG systems
    _colsum, _colnorm, _bc = _reducers("bm", None)
    cg0 = (jnp.zeros_like(b), b, b, b, _colsum(b * b), jnp.zeros((2,), bool))
    Z = jax.random.rademacher(jax.random.PRNGKey(0), (R, m), dtype=jnp.float64)

    fused = jax.jit(lambda s, z: fused_cg_slq_segment(op, s, z, k))
    state, ld1 = fused(cg0, Z)
    # resume CG with plain segments afterwards (the production pattern)
    step = _make_pcg_step(op, lambda rr: rr, _colsum, _bc)

    def seg(s):
        def body(ss, _):
            return step(*ss), None

        out, _ = lax.scan(body, s, None, length=60)
        return out

    state = jax.jit(seg)(state)
    # κ=50 → rate ≈0.755; 70 total iterations ≈ 3e-9 reduction
    np.testing.assert_allclose(
        np.asarray(state[0] @ A), np.asarray(b), rtol=1e-6, atol=1e-6
    )
    assert np.isfinite(float(ld1))
