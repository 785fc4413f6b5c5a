"""Multi-device scale-out: meshes, shard_map data parallelism, sharded solvers.

No reference counterpart (the reference is single-process — SURVEY.md §2);
built entirely on ``jax.sharding`` + XLA collectives.
"""

from gp_grief_jax.parallel.mesh import NamedSharding, P, data_mesh, init_distributed, make_mesh
from gp_grief_jax.parallel.model import ShardedGPGriefModel
from gp_grief_jax.parallel.ski import ShardedGPSKIRegression, build_sharded_interp
from gp_grief_jax.parallel.sharded import (
    kron_matvec_sharded,
    pad_to_multiple,
    sharded_basis_stats,
    sharded_grief_nlml,
    stacked_eigh_sharded,
)

__all__ = [
    "ShardedGPGriefModel",
    "ShardedGPSKIRegression",
    "build_sharded_interp",
    "make_mesh",
    "data_mesh",
    "init_distributed",
    "P",
    "NamedSharding",
    "pad_to_multiple",
    "sharded_basis_stats",
    "sharded_grief_nlml",
    "stacked_eigh_sharded",
    "kron_matvec_sharded",
]
