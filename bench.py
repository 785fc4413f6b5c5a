"""Kronecker matvec bandwidth on the GPU (the library's hot primitive).

    python bench.py [--d 5] [--m_d 32] [--rehearse]

One process.  Prints the card (``nvidia-smi`` name and power limit) and the
JAX device, then ONE JSON line: ``{"metric", "value", "unit",
"vs_baseline", "device", "detail"}``.

``value`` is the grouped cyclic XLA chain (:func:`gp_grief_jax.ops.
kron_matvec_fast`) at ``Precision.DEFAULT`` — the refined-CG inner-loop
operating point — as effective GB/s under the d-pass traffic model
``2·d·m·itemsize / t``.  ``vs_baseline`` divides it by a copy of the same
vector (``y = 2v + 1``: m floats read, m written) timed in the same
process, so the ratio carries no constant from another machine.

Timing: host clock around ``block_until_ready`` of a jitted ``fori_loop``
of ``ITERS`` chained applications (dispatch amortized), median of 5 warm
runs; compilation is reported separately as set-up
(:func:`gp_grief_jax.utils.profiling.time_chain`).

Without a GPU the script exits 2 and prints no result.  ``--rehearse`` runs
the same code on whatever backend JAX has (tiny CPU rehearsals in the
tests); the record names that device.  Any failed phase exits 1.
"""

from __future__ import annotations

import json
import sys

import numpy as np

ITERS = 20


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def kron_inputs(d: int, m_d: int, seed: int = 0):
    """Seeded host factors ``(m_d, m_d)`` scaled to ~unit spectral radius
    (chained matvecs stay finite) and a standard-normal ``(m_d**d,)``
    vector, both float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    factors = tuple(
        (rng.standard_normal((m_d, m_d)) / (2.2 * np.sqrt(m_d))).astype(np.float32)
        for _ in range(d)
    )
    v = rng.standard_normal(m_d**d).astype(np.float32)
    return factors, v


def measure_kron(factors, v, *, precision, target_width=None, iters: int = ITERS):
    """Time the grouped cyclic chain on device arrays ``factors``/``v``
    (``target_width=None``: the library's default grouping).  Returns
    ``{"compile_s", "ms", "gbs"}`` with ``gbs`` the effective bandwidth
    ``2·d·m·itemsize / t``."""
    from gp_grief_jax.ops import kron_matvec_fast
    from gp_grief_jax.utils.profiling import time_chain

    compile_s, t = time_chain(
        lambda vv: kron_matvec_fast(
            factors, vv, precision=precision, target_width=target_width
        ),
        v,
        iters=iters,
    )
    nbytes = 2 * len(factors) * v.size * v.dtype.itemsize
    return {"compile_s": compile_s, "ms": t * 1e3, "gbs": nbytes / t / 1e9}


def measure_copy(v, iters: int = ITERS):
    """Time ``y = 2v + 1`` (one read and one write of ``v``).  Returns
    ``{"compile_s", "ms", "gbs"}``."""
    from gp_grief_jax.utils.profiling import time_chain

    compile_s, t = time_chain(lambda vv: 2.0 * vv + 1.0, v, iters=iters)
    nbytes = 2 * v.size * v.dtype.itemsize
    return {"compile_s": compile_s, "ms": t * 1e3, "gbs": nbytes / t / 1e9}


def _parse_args(argv):
    args = {"d": 5, "m_d": 32, "rehearse": False}
    it = iter(argv)
    for a in it:
        if a == "--d":
            args["d"] = int(next(it))
        elif a == "--m_d":
            args["m_d"] = int(next(it))
        elif a == "--rehearse":
            args["rehearse"] = True
        else:
            raise SystemExit(f"unknown argument {a!r}")
    return args


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    import jax

    from gp_grief_jax.utils import enable_compilation_cache
    from gp_grief_jax.utils.profiling import card_line, device_record

    enable_compilation_cache()
    if jax.default_backend() != "gpu" and not args["rehearse"]:
        _log(f"no GPU (backend={jax.default_backend()}); nothing measured")
        return 2
    dev = device_record()
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__} device: {dev}", flush=True)
    d, m_d = args["d"], args["m_d"]
    try:
        factors, v = kron_inputs(d, m_d)
        factors = tuple(jax.device_put(f) for f in factors)
        v = jax.device_put(v)
        kron = measure_kron(factors, v, precision=jax.lax.Precision.DEFAULT)
        _log(f"kron chain: {kron['ms']:.4f} ms -> {kron['gbs']:.2f} GB/s eff")
        copy = measure_copy(v)
        _log(f"copy: {copy['ms']:.4f} ms -> {copy['gbs']:.2f} GB/s")
    except Exception as e:  # report, then fail the run
        _log(f"phase failed: {type(e).__name__}: {e}")
        return 1
    print(
        json.dumps(
            {
                "metric": "kron_matvec_bandwidth",
                "value": kron["gbs"],
                "unit": "GB/s",
                "vs_baseline": kron["gbs"] / copy["gbs"],
                "device": dev,
                "detail": {
                    "shape": f"(kron {d}x{m_d}^2)·v, m={m_d**d}",
                    "precision": "float32 data, Precision.DEFAULT",
                    "matvec_ms": kron["ms"],
                    "copy_GBs": copy["gbs"],
                    "copy_ms": copy["ms"],
                    "compile_s": kron["compile_s"] + copy["compile_s"],
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
