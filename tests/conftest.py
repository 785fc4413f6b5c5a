"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Parity tests run in float64 on the CPU backend (SURVEY.md §7 hard-part 1:
exact-GP parity math is validated in f64 here while the accelerator path
runs f32).  The 8 virtual devices exercise ``shard_map`` collectives
without a multi-card host (SURVEY.md §4 item 4).

Tests marked ``gpu`` need the card: they skip here (the ``gpu`` fixture
decides at run time) and run on a GPU host with
``GP_GRIEF_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu``, which
leaves the platform unpinned (``chip_smoke.py`` runs them first).
"""

import os

# Virtual-device flag must be set before the CPU backend initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("GP_GRIEF_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-dominated (CG/SLQ/eigh
# programs); repeat runs skip every recompile (~10 min cold -> ~3 min warm).
from gp_grief_jax.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips when the backend has none."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU (run: GP_GRIEF_TEST_GPU=1 python -m pytest "
            "tests/test_gpu.py -m gpu)"
        )
    return jax.devices()[0]
