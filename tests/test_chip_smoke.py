"""chip_smoke.py at tiny sizes on the CPU: the phase functions run and pass
their own checks, and the script itself refuses a machine without a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def phase_a_ctx():
    rep = chip_smoke.Report("cpu test")
    ctx = {}
    chip_smoke.phase_a(rep, ctx, n=700, n_train=500, mbar=5, p=40, steps=4)
    return rep, ctx


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_main_multichip_refuses_cpu(capsys):
    assert chip_smoke.main(["--multichip"]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_phase_a_tiny(phase_a_ctx):
    rep, ctx = phase_a_ctx
    assert rep.failures == []
    assert "a_model" in ctx and ctx["a_step_s"] > 0


def test_phase_b_tiny(phase_a_ctx):
    _, ctx = phase_a_ctx
    rep = chip_smoke.Report("cpu test")
    chip_smoke.phase_b(rep, ctx, kron_shapes=((3, 8), (4, 4)), ms=6, n_tables=3000,
                       n_wt=100)
    assert rep.failures == []


def test_phase_c_tiny():
    rep = chip_smoke.Report("cpu test")
    chip_smoke.phase_c(
        rep, {}, ski_lattice_n=3000, ski_data_n=400, ms=4, kron_m=6, gp_n=200,
        ski_tol=1e-2,  # 8 SLQ probes at ~12 points per cell
    )
    assert rep.failures == []


def test_multichip_on_virtual_cpu_devices():
    """The --multichip phase on 4 of the suite's 8 virtual CPU devices."""
    rep = chip_smoke.Report("cpu test")
    chip_smoke.phase_multichip(
        rep, {}, n=4000, mbar=4, p=20, steps=1, ski_n=300, ms=4, kron_m=8
    )
    assert rep.failures == []


def test_report_collects_failures(capsys):
    rep = chip_smoke.Report("cpu test")
    assert rep.check("X", "small", 1e-9, 1e-6, "reason")
    assert not rep.check("X", "nan", float("nan"), 1e-6, "reason")
    assert not rep.require("X", "flag", False, "detail")
    assert rep.failures == ["X:nan", "X:flag"]
    assert "FAIL" in capsys.readouterr().out
