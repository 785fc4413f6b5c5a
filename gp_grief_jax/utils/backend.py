"""Backend selection for scripts: ``--gpu`` runs on the GPU or not at all."""

from __future__ import annotations

__all__ = ["select_backend"]


def select_backend(gpu: bool, *, x64_on_cpu: bool = True) -> str:
    """Pin the process's JAX backend before its first use.

    ``gpu=True``: require the GPU backend — ``SystemExit`` when JAX finds
    none (no silent CPU fallback).  ``gpu=False``: the CPU, with float64
    enabled when ``x64_on_cpu``.  Returns the backend name.
    """
    import jax

    if gpu:
        if jax.default_backend() != "gpu":
            raise SystemExit(
                f"--gpu: JAX found no GPU (backend {jax.default_backend()!r})"
            )
        return "gpu"
    jax.config.update("jax_platforms", "cpu")
    if x64_on_cpu:
        jax.config.update("jax_enable_x64", True)
    return "cpu"
