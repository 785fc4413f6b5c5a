"""GRIEF eigenfunction basis: grid-structured Nyström features.

Re-design of the reference's ``GriefKernel`` (reference: ``gp_grief/kern.py``,
class ``GriefKernel`` — SURVEY.md §2 #13; algorithm from Evans & Nair,
ICML 2018).  The kernel is a truncated Nyström eigenfunction expansion on a
Cartesian inducing grid:

    k_GRIEF(x, z) = Σ_{j=1}^p w_j φ_j(x) φ_j(z),
    φ_j(x) = λ_j^{-1/2} · k(x, U) q_j,

where ``(λ_j, q_j)`` are the top-p eigenpairs of ``K_UU = ⊗_d K_d``.  Because
``q_j = ⊗_d q_{d, i_d(j)}`` factorizes, the feature matrix is a row/col-selected
Khatri-Rao product:

    Φ[i, j] = Π_d ( [K_xU_d Q_d][i, idx[j,d]] · λ_{d, idx[j,d]}^{-1/2} ),

with per-dimension normalization applied *inside* the product so intermediates
stay O(1) even at d=100 where the raw products span hundreds of orders of
magnitude (SURVEY.md §7 hard-part 2).  With ``w ≡ 1`` this reproduces the
Nyström kernel ``K_xU K_UU⁻¹ K_Ux`` exactly at ``p = m``.

Everything here is one jittable, differentiable function of the kernel
hyperparameters: batched per-dim ``eigh``, exact log-space
``top_p_kron_eigs`` selection, matmuls ``K_xU_d Q_d``, and a gather+product
assembly (the reference's "row-selection products", BASELINE.json:5) — so
``opt_kernel_params=True`` (rebuilding the eigenbasis every NLML evaluation,
SURVEY.md §3.2) is just including these ops in the traced objective.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from gp_grief_jax.kernels.base import param_dataclass
from gp_grief_jax.kernels.grid import KernList, cov_grid, cross_cov_grid
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.ops.kron import kron_eigh
from gp_grief_jax.ops.topk import top_p_kron_eigs

__all__ = ["GriefBasis", "build_basis", "phi"]


@param_dataclass
class GriefBasis:
    """Eigenfunction basis state (a pytree; all leaves are arrays).

    * ``Qs``: per-dimension eigenvector matrices ``(m_d, m_d)``.
    * ``lams``: per-dimension eigenvalue vectors ``(m_d,)`` (eigh order).
    * ``log_lam``: ``(p,)`` selected ``log Π_d λ`` — descending.
    * ``idx``: ``(p, d)`` int32 per-dimension eigenvector column selections.
    """

    Qs: Tuple[jax.Array, ...]
    lams: Tuple[jax.Array, ...]
    log_lam: jax.Array
    idx: jax.Array


def stack_kernels(
    kernels: Union[Stationary, KernList], xg, dims=None
) -> Optional[Stationary]:
    """Stack per-dim kernels into one pytree with a leading ``(d,)`` axis —
    or ``None`` when the dims cannot batch (unequal grids, mixed kernel
    kinds/shapes, grouped dims).

    Why: the d-unrolled basis/Φ graphs are what make high-d ARD gradients
    pathological — at d=100 the *backward* of the per-dim loop (a 100-link
    gather/scatter/product chain) executed in ~40 s/step on CPU where the
    batched form below runs in well under a second (round-3 weak #2 /
    next-step #5).  Stacked kernels turn d covs + d eighs + d Φ factors into
    ONE vmapped/einsum op each."""
    if dims is not None:
        return None
    if any(g.shape != xg[0].shape for g in xg):
        return None
    ks = (
        list(kernels)
        if isinstance(kernels, (list, tuple))
        else [kernels] * len(xg)
    )
    if len(ks) != len(xg) or len(ks) < 2:
        return None
    k0 = ks[0]
    if not all(
        isinstance(k, Stationary) and k.kind == k0.kind for k in ks
    ):
        return None
    shapes0 = [jnp.shape(l) for l in jax.tree_util.tree_leaves(k0)]
    for k in ks[1:]:
        if [jnp.shape(l) for l in jax.tree_util.tree_leaves(k)] != shapes0:
            return None
    return jax.tree.map(lambda *ls: jnp.stack([jnp.asarray(l) for l in ls]), *ks)


def build_basis(
    kernels: Union[Stationary, KernList],
    xg: Sequence[jax.Array],
    p: int,
    *,
    dim_noise_var: float = 1e-12,
) -> GriefBasis:
    """Build the eigenfunction basis: d small ``eigh``s + top-p selection.

    This is the reference's §3.1 construction stack (``GridKernel.cov_grid`` →
    ``KronMatrix.schur()`` → top-p Kronecker eigenvalue selection) as a single
    jitted program.  ``dim_noise_var`` is the per-dimension jitter stabilizing
    both the factor ``eigh`` and its gradient at near-degenerate eigenvalues
    (SURVEY.md §7 hard-part 4).

    When the dims batch (:func:`stack_kernels`) the d Gram builds run as ONE
    vmapped cov + ONE batched eigh — at d=100 the per-dim loop's graph (and
    especially its backward) is the ARD-training bottleneck.
    """
    # Clamp p to the lattice size when it is countable (asking for more
    # eigenfunctions than exist would otherwise pad the basis with duplicated
    # columns); for astronomically large grids the product is never the binding
    # constraint.
    log_total = sum(math.log(int(g.shape[0])) for g in xg)
    if log_total < math.log(2**62):
        p = min(p, math.prod(int(g.shape[0]) for g in xg))
    with jax.named_scope("grief_build_basis"):
        stacked = stack_kernels(kernels, xg)
        if stacked is not None:
            g_stack = jnp.stack([jnp.asarray(g) for g in xg])  # (d, m, s)
            Ks_st = jax.vmap(lambda k, g: k(g))(stacked, g_stack)  # (d, m, m)
            if dim_noise_var:
                Ks_st = Ks_st + dim_noise_var * jnp.eye(
                    Ks_st.shape[-1], dtype=Ks_st.dtype
                )
            lams_st, Qs_st = jax.vmap(jnp.linalg.eigh)(Ks_st)
            Qs = tuple(Qs_st[i] for i in range(len(xg)))
            lams = tuple(lams_st[i] for i in range(len(xg)))
        else:
            Ks = cov_grid(kernels, xg, dim_noise_var=dim_noise_var)
            Qs, lams = kron_eigh(Ks)
        log_lam, idx = top_p_kron_eigs(lams, p)
        return GriefBasis(Qs=Qs, lams=lams, log_lam=log_lam, idx=idx)


def phi(
    basis: GriefBasis,
    kernels: Union[Stationary, KernList],
    xg: Sequence[jax.Array],
    x: jax.Array,
    *,
    dims: Optional[Sequence[Sequence[int]]] = None,
    impl: str = "auto",
) -> jax.Array:
    """Evaluate the ``(n, p)`` normalized eigenfunction features at ``x``.

    Per dimension: one ``(n, m_d) × (m_d, m_d)`` matmul, a column gather,
    a per-column ``λ^{-1/2}`` scale, and a running elementwise product —
    ``O(n·Σ m_d² + n·p·d)`` total (reference §3.1 "build Φ" / §3.3 Nyström
    extension at test points).

    ``impl``: ``"auto"`` uses the BATCHED assembly when the dims stack
    (:func:`stack_kernels` — one vmapped cross-cov + one einsum + one
    product-reduce; at d=100 the per-dim loop's backward is a ~100-link
    gather/scatter chain) and the per-dim loop otherwise.  ``"batched"``
    forces the batched assembly (raises if inapplicable); ``"xla"`` forces
    the per-dim loop.  All paths are differentiable and run all dots at
    ``HIGHEST`` precision.
    """
    with jax.named_scope("grief_phi"):
        stacked = (
            stack_kernels(kernels, xg, dims) if impl in ("auto", "batched") else None
        )
        if impl == "batched" and stacked is None:
            raise ValueError(
                "phi(impl='batched') needs equal per-dim grids, matching "
                "per-dim kernels, and no dim grouping"
            )
        if stacked is not None:
            return _phi_batched(basis, stacked, xg, x)
        Kx = cross_cov_grid(kernels, x, xg, dims)
        tiny = jnp.finfo(Kx[0].dtype).tiny
        hi = jax.lax.Precision.HIGHEST
        out = None
        for d in range(len(xg)):
            # HIGHEST, matching the batched path (a DEFAULT f32 matmul runs
            # in TF32 on the GPU — three decimal digits).
            B = jnp.matmul(Kx[d], basis.Qs[d], precision=hi)
            cols = basis.idx[:, d]
            log_lam_d = jnp.log(jnp.clip(basis.lams[d], tiny, None))
            G = jnp.take(B, cols, axis=1) * jnp.exp(-0.5 * jnp.take(log_lam_d, cols))
            out = G if out is None else out * G
        return out


def _phi_batched(basis: GriefBasis, stacked: Stationary, xg, x: jax.Array) -> jax.Array:
    """Batched Φ assembly: ``Φ = Π_d (K_xU_d · S_d)`` with every per-dim
    piece a single batched op — the ``Q_d`` rotation, column selection and
    ``λ^{-1/2}`` normalization fold into ``S_d = Q_d[:, idx_d]·λ^{-1/2}``, the d
    cross-covs one vmapped kernel call, the d dots one einsum, the running
    product one ``prod`` reduce (whose VJP is two cumulative products, not a
    d-link chain)."""
    if x.ndim == 1:
        x = x[:, None]
    hi = jax.lax.Precision.HIGHEST
    g_stack = jnp.stack([jnp.asarray(g) for g in xg])  # (d, m, s)
    x_cols = jnp.moveaxis(x, 1, 0)[:, :, None]  # (d, n, 1): dim d ↦ column d
    Kx = jax.vmap(lambda k, xd, g: k(xd, g))(stacked, x_cols, g_stack)  # (d, n, m)
    Q_stack = jnp.stack(list(basis.Qs))  # (d, m, m)
    lam_stack = jnp.stack(list(basis.lams))  # (d, m)
    tiny = jnp.finfo(Kx.dtype).tiny
    loglam = jnp.log(jnp.clip(lam_stack, tiny, None))
    cols = basis.idx.T  # (d, p)
    S = jnp.take_along_axis(Q_stack, cols[:, None, :], axis=2)  # (d, m, p)
    scale = jnp.exp(-0.5 * jnp.take_along_axis(loglam, cols, axis=1))  # (d, p)
    B = jnp.einsum("dnm,dmp->dnp", Kx, S * scale[:, None, :], precision=hi)
    return jnp.prod(B, axis=0)
