"""Profiling helpers: traces, device identity and synchronized timings.

The counterpart of the reference's ``solver_counter`` timing prints
(SURVEY.md §5): hot ops carry ``jax.named_scope`` annotations (kron matvec,
basis build, Φ); wrap any region with :func:`trace` to dump a profiler
trace, use :func:`timed` for quick wall-clock spans, and
:func:`time_chain` / :func:`time_call` for device timings (host clock
around ``block_until_ready``, compilation reported separately).
:func:`card_line` and :func:`device_record` name what a number was
measured on.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "timed", "card_line", "device_record", "time_call", "time_chain"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed region into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-clock a region (synchronizing via ``block_until_ready`` is the
    caller's job: JAX returns before the device finishes)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[timed] {label}: {dt:.4f}s")


def card_line() -> str:
    """``name, power.limit`` of each visible NVIDIA card as ``nvidia-smi``
    reports it, or a note that it is unavailable."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (rc={out.returncode})"
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def _block(x):
    return jax.block_until_ready(x)


def time_call(fn, *args, reps: int = 5):
    """``(compile_s, warm_s, out)`` of ``jax.jit(fn)(*args)``: compile time
    of the ahead-of-time lowering, then the median host-clock time of
    ``reps`` synchronized warm calls."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = _block(compiled(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _block(compiled(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return compile_s, ts[len(ts) // 2], out


def time_chain(step, v, iters: int = 20, reps: int = 5):
    """``(compile_s, per_iter_s)`` of ``iters`` dependent applications of
    ``step`` chained in one jitted ``fori_loop`` (dispatch amortized over
    the chain).  ``optimization_barrier`` keeps XLA from fusing iterations
    into one pass."""
    def run(v):
        def body(_, vv):
            return jax.lax.optimization_barrier(step(vv))

        return jax.lax.fori_loop(0, iters, body, v)

    compile_s, warm_s, _ = time_call(run, v, reps=reps)
    return compile_s, warm_s / iters
