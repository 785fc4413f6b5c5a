"""Driver-contract smoke tests: bench.py emits one valid JSON line; the
__graft_entry__ hooks compile and run on the test mesh."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_bench_subprocess(extra_env, args=("--d", "3", "--m_d", "4", "--rehearse")):
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra_env)
    return subprocess.run(
        [sys.executable, os.path.join(root, "bench.py"), *args],
        env=env,
        capture_output=True,
        timeout=420,
    )


def _headline_record(proc):
    lines = [l for l in proc.stdout.decode().strip().splitlines() if l.strip()]
    assert lines[0].startswith("card: "), proc.stdout
    return json.loads(lines[-1])


def test_bench_emits_valid_json_line():
    proc = _run_bench_subprocess({})
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    rec = _headline_record(proc)
    for key in ("metric", "value", "unit", "vs_baseline", "device"):
        assert key in rec
    assert rec["metric"] == "kron_matvec_bandwidth"
    assert rec["device"]["platform"] == "cpu"
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert np.isfinite(rec["vs_baseline"]) and rec["vs_baseline"] > 0


def test_bench_refuses_cpu_without_rehearse():
    """A measurement run that finds no GPU fails and prints no record."""
    proc = _run_bench_subprocess({}, args=("--d", "3", "--m_d", "4"))
    assert proc.returncode == 2
    assert "metric" not in proc.stdout.decode()


def test_bench_exits_nonzero_when_a_phase_fails(monkeypatch, capsys):
    import bench

    def broken(*a, **k):
        raise RuntimeError("injected phase failure")

    monkeypatch.setattr(bench, "measure_copy", broken)
    rc = bench.main(["--d", "2", "--m_d", "4", "--rehearse"])
    assert rc == 1
    assert "metric" not in capsys.readouterr().out


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out))
    ge.dryrun_multichip(2)  # 1-D data mesh on the 8 virtual devices


@pytest.mark.slow
def test_dryrun_multichip_driver_exact():
    """The driver's EXACT invocation — ``dryrun_multichip(8)`` in a fresh
    subprocess with NO inherited virtual-device flags (this is what crashed in
    round 1: the entry must self-configure the 8-device backend)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # Scrub anything the conftest set up; the entry must do it itself.
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as ge; ge.dryrun_multichip(8)"],
        env=env,
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr}\nstdout:\n{r.stdout}"
    assert "dryrun_multichip OK" in r.stdout
    assert "'data': 4" in r.stdout and "'model': 2" in r.stdout


@pytest.mark.slow
def test_dryrun_multichip_subprocess_fallback():
    """When jax is ALREADY initialized with too few devices, the entry must
    fall back to a fresh subprocess of virtual CPU devices, and say so."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "assert len(jax.devices()) == 1, jax.devices(); "  # backend up, 1 device
        "import __graft_entry__ as ge; ge.dryrun_multichip(4)"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr}\nstdout:\n{r.stdout}"
    assert "dryrun_multichip OK" in r.stdout
    assert "virtual CPU devices" in r.stdout


@pytest.mark.slow
def test_cli_checkgrad_smoke():
    """``python -m gp_grief_jax checkgrad`` (SURVEY §5: the reference's
    checkgrad parity table kept as a CLI subcommand) exits 0 and prints OK."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "gp_grief_jax", "checkgrad"],
        env=env,
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, f"stderr:\n{r.stderr}\nstdout:\n{r.stdout}"
    assert "checkgrad table" in r.stdout and "OK" in r.stdout
