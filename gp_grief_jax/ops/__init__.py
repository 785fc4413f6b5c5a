"""Structured tensor algebra + iterative linear algebra (reference L0+L1).

JAX replacements for the reference's ``gp_grief/tensors.py`` and
``gp_grief/linalg.py`` (SURVEY.md §2 #1–#9): Kronecker / Khatri-Rao operators
as pytrees-of-factors with pure-function matvecs, selection as gathers, exact
log-space top-p Kronecker eigenvalue selection, and CG / Lanczos / SLQ as
``lax`` pipelines.
"""

from gp_grief_jax.ops.kron import (
    kron_chol,
    kron_diag,
    kron_eigh,
    kron_expand,
    kron_logdet_from_chol,
    kron_logdet_from_eigs,
    kron_matmat,
    kron_matvec,
    kron_shapes,
    kron_solve_schur,
    kron_svd,
)
from gp_grief_jax.ops.khatri_rao import (
    kr_expand,
    kr_matvec,
    kr_rmatvec,
    rowcol_kr_expand,
    rowcol_kr_matvec,
    rowcol_kr_rmatvec,
)
from gp_grief_jax.ops.kron_fast import group_factors, kron_matvec_fast
from gp_grief_jax.ops.precond import (
    kron_deflation_preconditioner,
    kron_deflation_sqrt_ops,
    lowrank_preconditioner,
    lowrank_spectral_factor,
    lowrank_sqrt_ops,
    lowrank_sqrt_ops_from_factor,
    pivoted_cholesky,
)
from gp_grief_jax.ops.compose import op_product, op_scale, op_shift, op_sum
from gp_grief_jax.ops.interp import (
    InterpPlan,
    InterpWeights,
    build_corner_stream,
    build_interp_plan,
    interp_expand,
    interp_matvec,
    interp_matvec_bm,
    interp_matvec_bm_fast,
    interp_rmatvec,
    interp_rmatvec_bm,
    interp_rmatvec_bm_exact,
    interp_rmatvec_bm_fast,
    interp_weights,
)
from gp_grief_jax.ops.selection import select_rows, select_rows_t, selection_expand
from gp_grief_jax.ops.topk import top_p_kron_eigs
from gp_grief_jax.ops.batching import safe_batch_op
from gp_grief_jax.ops.cg import (
    cg_solve_refined,
    cg_solve_refined_segmented,
    cg_solve_segmented,
    CGInfo,
    cg_solve,
)
from gp_grief_jax.ops.lanczos import LanczosResult, lanczos, lanczos_batched, slq_logdet, slq_logdet_segmented
from gp_grief_jax.ops.solve import logdet_from_chol, solve_chol, stable_cholesky

__all__ = [
    "kron_matvec_fast",
    "kron_deflation_preconditioner",
    "kron_deflation_sqrt_ops",
    "lowrank_preconditioner",
    "lowrank_spectral_factor",
    "lowrank_sqrt_ops",
    "lowrank_sqrt_ops_from_factor",
    "pivoted_cholesky",
    "group_factors",
    "op_product",
    "op_sum",
    "op_scale",
    "op_shift",
    "InterpWeights",
    "interp_weights",
    "build_corner_stream",
    "safe_batch_op",
    "build_interp_plan",
    "InterpPlan",
    "interp_matvec",
    "interp_matvec_bm",
    "interp_matvec_bm_fast",
    "interp_rmatvec",
    "interp_rmatvec_bm",
    "interp_rmatvec_bm_exact",
    "interp_rmatvec_bm_fast",
    "interp_expand",
    "kron_matvec",
    "kron_matmat",
    "kron_expand",
    "kron_diag",
    "kron_eigh",
    "kron_chol",
    "kron_logdet_from_chol",
    "kron_logdet_from_eigs",
    "kron_solve_schur",
    "kron_svd",
    "kron_shapes",
    "kr_matvec",
    "kr_rmatvec",
    "kr_expand",
    "rowcol_kr_expand",
    "rowcol_kr_matvec",
    "rowcol_kr_rmatvec",
    "select_rows",
    "select_rows_t",
    "selection_expand",
    "top_p_kron_eigs",
    "cg_solve",
    "cg_solve_refined",
    "cg_solve_refined_segmented",
    "cg_solve_segmented",
    "CGInfo",
    "lanczos",
    "lanczos_batched",
    "slq_logdet",
    "slq_logdet_segmented",
    "LanczosResult",
    "solve_chol",
    "stable_cholesky",
    "logdet_from_chol",
]
