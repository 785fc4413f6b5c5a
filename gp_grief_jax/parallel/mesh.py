"""Device-mesh helpers (the framework's only "communication backend").

The reference is single-process with no distributed execution (SURVEY.md §2
parallelism census); scale-out here is new design surface built entirely on
``jax.sharding``: pick a mesh, annotate shardings, let XLA insert the
collectives (NCCL over NVLink on a GPU host).  The cards of a host are
joined all to all, so a mesh's shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_mesh", "init_distributed", "P", "NamedSharding"]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-process initialization (one process per host or per card).

    ``jax.distributed.initialize`` must run BEFORE any backend use, after
    which ``jax.devices()`` spans every process and the ordinary
    :func:`make_mesh` / model ``mesh=`` kwargs work unchanged.

    Single-process (the common case: one process drives every card of a
    host): a NO-OP returning 1 — decided from the arguments and the
    environment ONLY, never by probing jax (``jax.process_count()`` would
    initialize the local backend, after which ``jax.distributed.initialize``
    refuses to run).  Multi-process: call this BEFORE any other jax use,
    passing the coordinator address (``host:port``), ``num_processes`` and
    ``process_id`` explicitly, or with no arguments when
    ``$COORDINATOR_ADDRESS`` announces a coordinator.  Returns
    ``jax.process_count()`` (1 on the no-op path).
    """
    import os
    import warnings

    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    if not explicit and "COORDINATOR_ADDRESS" not in os.environ:
        return 1  # bare single process: touch nothing
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Backend already initialized (or double call): report what we have
        # rather than crashing a program that may still be single-process.
        warnings.warn(
            f"init_distributed: jax.distributed.initialize failed ({e}); "
            "call init_distributed() before any other jax use",
            stacklevel=2,
        )
    return jax.process_count()


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh of the given logical shape over the available devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over all (or the first ``n_devices``) devices."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return make_mesh((n,), (axis_name,), devices=devs[:n])
