"""Real-dataset loader tests (benchmarks/data.py) against synthetic fixtures.

The environment is zero-egress, so the genuine kin40k / UCI files cannot be
fetched; these tests exercise the activation-on-file-drop code paths with
tmpdir fixtures so a real drop works first try.
``run_configs`` selects the ``*_real`` tag exactly when the loader returns
non-None (benchmarks/run_configs.py kin40k/uci2m), which these tests pin.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.data import load_kin40k, load_uci2m, standardize  # noqa: E402


def _write_kin40k_npz(root, n_tr=20, n_te=8, d=8):
    rng = np.random.default_rng(0)
    np.savez(
        os.path.join(root, "kin40k.npz"),
        x_train=rng.standard_normal((n_tr, d)),
        y_train=rng.standard_normal(n_tr),
        x_test=rng.standard_normal((n_te, d)),
        y_test=rng.standard_normal(n_te),
    )


def test_load_kin40k_absent_returns_none(tmp_path):
    assert load_kin40k(root=str(tmp_path)) is None
    assert load_uci2m(root=str(tmp_path)) is None


def test_load_kin40k_npz(tmp_path):
    _write_kin40k_npz(str(tmp_path))
    out = load_kin40k(root=str(tmp_path))
    assert out is not None
    xt, yt, xe, ye = out
    assert xt.shape == (20, 8) and yt.shape == (20,)
    assert xe.shape == (8, 8) and ye.shape == (8,)
    assert all(a.dtype == np.float32 for a in out)
    # run_configs' real-vs-synth branch is literally `real is not None`.


def test_load_kin40k_asc(tmp_path):
    rng = np.random.default_rng(1)
    parts = {
        "train_data": rng.standard_normal((12, 8)),
        "train_labels": rng.standard_normal((12, 1)),  # column labels OK
        "test_data": rng.standard_normal((5, 8)),
        "test_labels": rng.standard_normal(5),
    }
    for name, arr in parts.items():
        np.savetxt(os.path.join(str(tmp_path), f"kin40k_{name}.asc"), arr)
    xt, yt, xe, ye = load_kin40k(root=str(tmp_path))
    assert xt.shape == (12, 8) and yt.shape == (12,)
    assert xe.shape == (5, 8) and ye.shape == (5,)
    np.testing.assert_allclose(yt, parts["train_labels"][:, 0], rtol=1e-6)


def test_load_kin40k_env_dir(tmp_path, monkeypatch):
    """$GP_GRIEF_DATA points the default root at the drop directory."""
    _write_kin40k_npz(str(tmp_path))
    monkeypatch.setenv("GP_GRIEF_DATA", str(tmp_path))
    assert load_kin40k() is not None


def test_load_kin40k_malformed_fails_loudly(tmp_path):
    rng = np.random.default_rng(2)
    np.savez(
        os.path.join(str(tmp_path), "kin40k.npz"),
        x_train=rng.standard_normal((20, 8)),
        y_train=rng.standard_normal(19),  # length mismatch
        x_test=rng.standard_normal((8, 8)),
        y_test=rng.standard_normal(8),
    )
    with pytest.raises(ValueError, match="labels"):
        load_kin40k(root=str(tmp_path))
    np.savez(os.path.join(str(tmp_path), "kin40k.npz"), x_train=np.zeros((3, 2)))
    with pytest.raises(ValueError, match="missing"):
        load_kin40k(root=str(tmp_path))
    # feature-dim mismatch between splits
    np.savez(
        os.path.join(str(tmp_path), "kin40k.npz"),
        x_train=rng.standard_normal((20, 8)),
        y_train=rng.standard_normal(20),
        x_test=rng.standard_normal((8, 7)),
        y_test=rng.standard_normal(8),
    )
    with pytest.raises(ValueError, match="feature dims"):
        load_kin40k(root=str(tmp_path))


def test_load_uci2m_npz_and_malformed(tmp_path):
    rng = np.random.default_rng(3)
    np.savez(
        os.path.join(str(tmp_path), "uci2m.npz"),
        x=rng.standard_normal((50, 4)),
        y=rng.standard_normal((50, 1)),  # column y reshapes fine
    )
    x, y = load_uci2m(root=str(tmp_path))
    assert x.shape == (50, 4) and y.shape == (50,) and x.dtype == np.float32
    np.savez(
        os.path.join(str(tmp_path), "uci2m.npz"),
        x=rng.standard_normal((50, 4)),
        y=rng.standard_normal(49),
    )
    with pytest.raises(ValueError, match="matching y"):
        load_uci2m(root=str(tmp_path))
    np.savez(os.path.join(str(tmp_path), "uci2m.npz"), x=rng.standard_normal((5, 2)))
    with pytest.raises(ValueError, match="missing"):
        load_uci2m(root=str(tmp_path))


def test_standardize_training_statistics():
    """Stats come from the training split ONLY (the paper's protocol)."""
    rng = np.random.default_rng(4)
    xt = 3.0 + 2.0 * rng.standard_normal((200, 3))
    yt = -1.0 + 0.5 * rng.standard_normal(200)
    xe = rng.standard_normal((50, 3))
    ye = rng.standard_normal(50)
    xts, yts, xes, yes, ys = standardize(xt, yt, xe, ye)
    np.testing.assert_allclose(xts.mean(0), 0.0, atol=1e-10)
    np.testing.assert_allclose(xts.std(0), 1.0, rtol=1e-6)
    np.testing.assert_allclose(yts.mean(), 0.0, atol=1e-10)
    # test split transformed with TRAIN stats, not its own
    np.testing.assert_allclose(xes, (xe - xt.mean(0)) / (xt.std(0) + 1e-12))
    assert ys == pytest.approx(yt.std() + 1e-12)


def _run_config(name, data_dir, extra_env=None, timeout=900):
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["GP_GRIEF_DATA"] = str(data_dir)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    r = subprocess.run(
        [sys.executable, "-c",
         f"from benchmarks.run_configs import {name}; {name}(accelerator=False)"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=timeout,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr[-2000:]}\nstdout:\n{r.stdout}"
    return r.stdout


@pytest.mark.slow
def test_kin40k_config_runs_on_real_file_drop(tmp_path):
    """End-to-end: dropping a kin40k.npz makes the config run the REAL-data
    path (tag kin40k_real, standardize protocol) — the activation the
    loaders exist for, exercised with a tiny synthetic file on CPU."""
    rng = np.random.default_rng(0)
    n_tr, n_te, d = 400, 80, 4
    x = rng.uniform(-1, 1, size=(n_tr + n_te, d))
    f = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] * x[:, 2]
    y = f + 0.05 * rng.standard_normal(len(x))
    np.savez(os.path.join(str(tmp_path), "kin40k.npz"),
             x_train=x[:n_tr], y_train=y[:n_tr],
             x_test=x[n_tr:], y_test=y[n_tr:])
    out = _run_config("kin40k", tmp_path)
    import json

    rec = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert rec["config"] == "kin40k_real"
    assert np.isfinite(rec["rmse"]) and np.isfinite(rec["nll"])


@pytest.mark.slow
def test_uci2m_config_runs_on_real_file_drop(tmp_path):
    """Same activation test for uci2m.npz — proportional splits keep the
    config runnable on a smaller-than-2M file."""
    rng = np.random.default_rng(1)
    n, d = 3000, 4
    x = rng.uniform(-1, 1, size=(n, d))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    np.savez(os.path.join(str(tmp_path), "uci2m.npz"), x=x, y=y)
    out = _run_config("uci2m", tmp_path)
    import json

    rec = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
    assert rec["config"] == "uci2m_real"
    assert np.isfinite(rec["rmse"]) and np.isfinite(rec["nlml_closed"])
    assert rec["slq_cg_nlml_gap"] < 0.05
