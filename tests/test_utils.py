"""Utils: checkpoint round-trip, metric logger, checkify guards, GPGrief
iterative path + structured matvec."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_grief_jax import GPGriefModel, InducingGrid, make_kernel
from gp_grief_jax.utils import MetricLogger, load_pytree, save_pytree
from gp_grief_jax.utils.checks import guarded


def test_checkpoint_roundtrip(tmp_path, rng):
    params = {
        "log_w": jnp.asarray(rng.standard_normal(5)),
        "nested": {"a": jnp.asarray(2.5), "ks": [jnp.ones((2, 2)), jnp.zeros(3)]},
    }
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, params)
    zeroed = jax.tree.map(jnp.zeros_like, params)
    restored = load_pytree(path, zeroed)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_optimization(tmp_path, rng):
    x = rng.uniform(0, 4, size=(60, 1))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(60)
    m1 = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=10, noise_var=0.3)
    m1.optimize(max_iters=10)
    path = str(tmp_path / "params.npz")
    save_pytree(path, m1.params)
    m2 = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=6, mbar=10, noise_var=0.3)
    m2.params = load_pytree(path, m2.params)
    np.testing.assert_allclose(m1.log_likelihood(), m2.log_likelihood(), rtol=1e-12)


def test_metric_logger(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with MetricLogger(path) as log:
        log.log(step=1, nlml=3.5)
        log.log(step=2, nlml=2.5, cg_iters=7)
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["step"] == 1 and lines[1]["cg_iters"] == 7
    assert all("t" in l for l in lines)


def test_guarded_catches_nonfinite():
    def bad(x):
        return jnp.log(x)  # -inf at 0

    g = jax.jit(lambda x: x) and guarded(bad)
    with pytest.raises(Exception):
        g(jnp.asarray(0.0))
    ok = guarded(lambda x: x * 2)
    assert float(ok(jnp.asarray(3.0))) == 6.0


def test_grief_iterative_nlml_and_matvec(rng):
    x = rng.uniform(0, 4, size=(150, 1))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(150)
    model = GPGriefModel(x, y, [make_kernel("rbf", lengthscale=0.5)], n_eigs=12, mbar=20, noise_var=0.1)
    ll_exact = model.log_likelihood()
    ll_iter = model.log_likelihood_iterative(num_probes=96, lanczos_iters=40)
    assert abs(ll_iter - ll_exact) / abs(ll_exact) < 0.05
    # structured matvec matches dense K̃ = Φ W Φᵀ + σ² I
    from gp_grief_jax.kernels.grief import phi

    Phi = np.asarray(phi(model._basis, model.params["kernels"], model.xg, model.x))
    w = np.exp(np.asarray(model.params["log_w"]))
    K = Phi * w @ Phi.T + np.exp(float(model.params["log_noise"])) * np.eye(len(y))
    v = rng.standard_normal(len(y))
    np.testing.assert_allclose(np.asarray(model.kernel_matvec(jnp.asarray(v))), K @ v, rtol=1e-8)


def test_fit_resume_matches_uninterrupted(rng, tmp_path):
    """SURVEY §5 checkpoint/resume: fit(n) + fit(m, opt_state=restored)
    reproduces fit(n+m) exactly, with params AND optimizer state round-
    tripped through the .npz checkpoint."""
    import os

    import jax.numpy as jnp

    from gp_grief_jax.optimize import fit
    from gp_grief_jax.utils.checkpoint import load_pytree, save_pytree

    A = jnp.asarray(rng.standard_normal((6, 3)))
    b = jnp.asarray(rng.standard_normal(6))

    def loss(p):
        r = A @ p["w"] - b
        return jnp.dot(r, r) + 0.1 * jnp.sum(p["w"] ** 2)

    p0 = {"w": jnp.zeros(3)}
    full = fit(loss, p0, optimizer="adam", max_iters=12, learning_rate=0.1,
               tol=0.0)
    half = fit(loss, p0, optimizer="adam", max_iters=6, learning_rate=0.1,
               tol=0.0)
    # checkpoint params + optimizer state, restore, resume
    ck = os.path.join(str(tmp_path), "ck.npz")
    save_pytree(ck, {"params": half.params, "opt": half.opt_state})
    restored = load_pytree(ck, {"params": half.params, "opt": half.opt_state})
    resumed = fit(loss, restored["params"], optimizer="adam", max_iters=6,
                  learning_rate=0.1, tol=0.0, opt_state=restored["opt"])
    np.testing.assert_allclose(
        np.asarray(resumed.params["w"]), np.asarray(full.params["w"]),
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.concatenate([half.losses, resumed.losses]), full.losses,
        rtol=1e-12,
    )


def test_compilation_cache_honours_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the cache is that directory and no
    other is configured; without it, the fixed in-checkout .jax_cache/."""
    from gp_grief_jax.utils import compilation_cache as cc

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.cache_dir() == cc.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# Spelled in pieces so that this file does not itself match the search.
_ACCEL_ONLY = ("pallas." + "t" + "pu", "pl" + "t" + "pu", "v" + "5e", "RESULTS_r", "interpret=")


def test_no_accelerator_specific_code_left():
    """No module of the library, bench.py, chip_smoke.py or an example
    imports a Mosaic-only Pallas backend, runs a Pallas interpreter, or
    cites a deleted results file or the former chip."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, "bench.py"), os.path.join(repo, "chip_smoke.py")]
    for top in ("gp_grief_jax", "examples"):
        for dirpath, _, files in os.walk(os.path.join(repo, top)):
            paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    for path in paths:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for word in _ACCEL_ONLY:
            assert word not in text, (os.path.relpath(path, repo), word)
