"""Data-parallel SKI regression: sharded interpolation rows, replicated lattice.

New design surface with no reference counterpart (SURVEY.md §2 parallelism
census — the reference is single-process).  SKI's O(n) work is the sparse
interpolation ``W`` / ``Wᵀ`` and the CG/SLQ solver state; both shard cleanly
over the ``data`` axis of a mesh while the lattice (``⊗_d K_d``, size M)
stays replicated:

    device k holds rows x_k, y_k and its own scatter-free interpolation
    plan (ops/interp.py InterpPlan, built per shard on host):
        Wᵀ v  =  Σ_k Wᵀ_k v_k      → one (B, M) psum
        ⊗K_d  matvec               → replicated (tiny vs the O(n) gathers)
        W u                         → local gather rows
    CG / Lanczos inner products    → psum (ops.cg/lanczos axis_name hooks)

so each operator application costs exactly TWO collectives: the (B, M)
lattice reduction and the solver's (B,) dot-product psum.  The rank-r
deflation preconditioner (models/gp_ski.py:_build_precond) is built sharded
too: its skinny factor ``U (n, r)`` rows live on their owning devices and the
CholeskyQR2 Gram reductions are r×r psums.

Padding: rows are zero-padded to the mesh size with a row mask applied as a
congruence (``Â = mask∘(W K Wᵀ)∘mask + σ²I``), which block-decouples pad rows
(they see a pure σ² identity); the log-det correction ``−(n_pad−n)·log σ²``
and masked gradient probes make every NLML quantity exactly the real-data
one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gp_grief_jax.grid import InducingGrid
from gp_grief_jax.kernels.base import inverse_positive
from gp_grief_jax.kernels.grid import cov_grid
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.models.base import BaseModel
from gp_grief_jax.ops.cg import cg_solve
from gp_grief_jax.ops.interp import (
    InterpPlan,
    build_corner_stream,
    build_interp_plan,
    interp_matvec_bm_fast,
    interp_rmatvec_bm_exact,
    interp_weights,
)
from gp_grief_jax.ops.interp_windowed import (
    WindowedPlan,
    build_windowed_plan,
    matvec_sorted_p,
    plan_split,
    rmatvec_sorted_p,
)
from gp_grief_jax.ops.kron import kron_eigh
from gp_grief_jax.ops.kron_fast import kron_matvec_fast
from gp_grief_jax.ops.lanczos import slq_logdet
from gp_grief_jax.ops.solve import stable_cholesky
from gp_grief_jax.ops.topk import top_p_kron_eigs
from gp_grief_jax.parallel.mesh import data_mesh
from gp_grief_jax.parallel.sharded import pad_to_multiple

__all__ = ["ShardedGPSKIRegression", "build_sharded_interp"]


def build_sharded_interp(x_pad: np.ndarray, xg, n_devices: int, with_plan: bool = True):
    """Per-shard interpolation plans, stacked for ``shard_map``.

    Splits the (padded) rows into ``n_devices`` equal blocks, builds each
    block's :class:`InterpPlan` on host, pads the data-dependent extents
    (ELL width ``K``, overflow length, sorted-stream length) to the maxima
    with weight-0 entries (inert by construction: a 0-weight slot/overflow
    update adds exactly 0), and stacks every field on a leading device axis.
    Returns ``(stacked_plan, stacked_idx, stacked_w)`` where ``stacked_idx/w``
    are the per-dim interpolation indices/weights ``(n_devices, n_loc)`` /
    ``(n_devices, n_loc, 2)`` used by the sharded preconditioner build (the
    lattice shape rides on ``stacked_plan.shape``).
    """
    n_pad = x_pad.shape[0]
    assert n_pad % n_devices == 0
    n_loc = n_pad // n_devices
    iws = []
    for k in range(n_devices):
        iws.append(interp_weights(jnp.asarray(x_pad[k * n_loc : (k + 1) * n_loc]), xg))
    stacked_idx = tuple(
        jnp.asarray(np.stack([np.asarray(iw.idx[d]) for iw in iws]))
        for d in range(len(xg))
    )
    stacked_w = tuple(
        jnp.asarray(np.stack([np.asarray(iw.w[d]) for iw in iws]))
        for d in range(len(xg))
    )
    if not with_plan:
        # Caller uses windowed plans for the applies; only the per-dim
        # interpolation indices/weights (preconditioner build) are needed —
        # skip the flat plan's large stacked tables.
        return None, stacked_idx, stacked_w
    plans = [build_interp_plan(iw) for iw in iws]
    shape = plans[0].shape
    K = max(int(p.slot_src.shape[1]) for p in plans)
    OV = max(int(p.ov_ids.shape[0]) for p in plans)
    NS = max(int(p.src_col.shape[0]) for p in plans)

    def _pad_axis(a, target, axis, fill=0):
        a = np.asarray(a)
        padn = target - a.shape[axis]
        if padn == 0:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, padn)
        return np.pad(a, widths, constant_values=fill)

    fields = {}
    for name in ("src_col", "w_sorted", "start_ptr", "end_ptr", "gather_flat",
                 "gather_w", "slot_src", "slot_w", "ov_ids", "ov_src", "ov_w"):
        arrs = [np.asarray(getattr(p, name)) for p in plans]
        if name in ("src_col", "w_sorted"):
            arrs = [_pad_axis(a, NS, 0) for a in arrs]
        elif name in ("slot_src", "slot_w"):
            arrs = [_pad_axis(a, K, 1) for a in arrs]
        elif name in ("ov_ids", "ov_src", "ov_w"):
            arrs = [_pad_axis(a, OV, 0) for a in arrs]
        fields[name] = jnp.asarray(np.stack(arrs))
    stacked_plan = InterpPlan(shape=shape, **fields)
    return stacked_plan, stacked_idx, stacked_w


_WINDOWED_MIN_DIM = 200_000
"""Use the windowed interpolation applies (ops/interp_windowed.py) inside
the sharded model when either gather source — the replicated (B, M)
lattice or a shard's (B, n_loc) data rows — reaches the size where XLA's
big-source gathers run slowest."""


def build_sharded_windowed_interp(x_pad: np.ndarray, xg, n_devices: int):
    """Per-shard :class:`WindowedPlan`s stacked for ``shard_map``.

    Two passes: build each shard's plan to learn its derived statics, then
    rebuild every shard with the maxima FORCED (identical ``K/Wr/Wc`` →
    identical ``Cb/T/P/Tp`` since all shards share ``n_loc`` and ``M``),
    pad the overflow streams to the longest with weight-0 entries, and
    stack each field on a leading device axis.  Returns ``None`` if any
    shard's plan cannot build (windows unbounded — clustered data).
    """
    n_pad = x_pad.shape[0]
    assert n_pad % n_devices == 0
    n_loc = n_pad // n_devices
    iws = [
        interp_weights(jnp.asarray(x_pad[k * n_loc : (k + 1) * n_loc]), xg)
        for k in range(n_devices)
    ]
    # One corner stream per shard, shared by both build passes (the second
    # pass only re-derives the force_*-dependent fills).
    streams = [build_corner_stream(iw) for iw in iws]
    first = [build_windowed_plan(iw, stream=st) for iw, st in zip(iws, streams)]
    if any(p is None for p in first):
        return None
    K = max(int(p.wt_loc.shape[-1]) for p in first)
    Wr = max(int(p.Wr) for p in first)
    Wc = max(int(p.Wc) for p in first)
    plans = [
        build_windowed_plan(iw, force_slots=K, force_wr=Wr, force_wc=Wc, stream=st)
        for iw, st in zip(iws, streams)
    ]
    if any(p is None for p in plans):
        return None
    ref = plans[0]
    assert all(
        (p.T, p.Cb, p.P, p.Tp, p.Wr, p.Wc) == (ref.T, ref.Cb, ref.P, ref.Tp, ref.Wr, ref.Wc)
        for p in plans
    ), "forced windowed plans must share static shapes"
    OV = max(int(p.ov_ids.shape[0]) for p in plans)

    def _pad0(a, target):
        a = np.asarray(a)
        if a.shape[0] == target:
            return a
        return np.pad(a, (0, target - a.shape[0]))

    fields = {}
    for name in ("perm", "inv_perm", "wt_starts", "wt_loc", "wt_w",
                 "w_starts", "w_loc", "w_w"):
        fields[name] = jnp.asarray(np.stack([np.asarray(getattr(p, name)) for p in plans]))
    for name in ("ov_ids", "ov_src", "ov_w"):
        fields[name] = jnp.asarray(
            np.stack([_pad0(getattr(p, name), OV) for p in plans])
        )
    statics = {k: getattr(ref, k) for k in ("Wr", "Cb", "T", "Wc", "P", "Tp", "M", "n")}
    return WindowedPlan(**fields, **statics)


_WPLAN_ARRAY_FIELDS = (
    "perm", "inv_perm", "wt_starts", "wt_loc", "wt_w",
    "ov_ids", "ov_src", "ov_w", "w_starts", "w_loc", "w_w",
)
_WPLAN_STATIC_FIELDS = ("Wr", "Cb", "T", "Wc", "P", "Tp", "M", "n")


def _wplan_arrays(stacked: WindowedPlan):
    """The stacked plan's array fields as a tuple for ``shard_map``.

    The plan's static ints must NOT ride through shard_map as pytree
    leaves — they would trace to scalars, and the windowed impls need them
    as python ints (dynamic_slice sizes, reshape extents).  Arrays travel
    as arguments; statics are re-attached locally by :func:`_local_wplan`
    from the host-side plan object."""
    return tuple(getattr(stacked, f) for f in _WPLAN_ARRAY_FIELDS)


def _wplan_arr_specs(stacked: WindowedPlan, axis_name: str):
    """``shard_map`` specs matching :func:`_wplan_arrays` (leading device
    axis sharded, everything else replicated)."""
    return tuple(
        P(axis_name, *([None] * (np.asarray(getattr(stacked, f)).ndim - 1)))
        for f in _WPLAN_ARRAY_FIELDS
    )


def _local_wplan(arrs, stacked: WindowedPlan) -> WindowedPlan:
    """Local :class:`WindowedPlan` from shard_map-sliced array fields (the
    leading device axis is stripped) + the host plan's static ints."""
    kw = {name: a[0] for name, a in zip(_WPLAN_ARRAY_FIELDS, arrs)}
    for k in _WPLAN_STATIC_FIELDS:
        kw[k] = getattr(stacked, k)
    return WindowedPlan(**kw)


def _local_plan(stacked: InterpPlan) -> InterpPlan:
    """Strip the leading (device) axis shard_map leaves on each field."""
    return InterpPlan(
        shape=stacked.shape,
        **{
            name: getattr(stacked, name)[0]
            for name in ("src_col", "w_sorted", "start_ptr", "end_ptr",
                         "gather_flat", "gather_w", "slot_src", "slot_w",
                         "ov_ids", "ov_src", "ov_w")
        },
    )


def _plan_specs(axis_name: str) -> InterpPlan:
    """``shard_map`` spec pytree matching a stacked :class:`InterpPlan`."""
    return InterpPlan(
        src_col=P(axis_name, None),
        w_sorted=P(axis_name, None),
        start_ptr=P(axis_name, None),
        end_ptr=P(axis_name, None),
        gather_flat=P(axis_name, None, None),
        gather_w=P(axis_name, None, None),
        slot_src=P(axis_name, None, None),
        slot_w=P(axis_name, None, None),
        ov_ids=P(axis_name, None),
        ov_src=P(axis_name, None),
        ov_w=P(axis_name, None),
        shape=None,  # static
    )


def _sharded_lowrank_ops(U_loc, lam, sigma2, axis_name):
    """Row-sharded :func:`gp_grief_jax.ops.precond.lowrank_sqrt_ops`:
    ``U_loc (n_loc, r)`` are this device's rows of the orthonormal basis; the
    r-vector contraction is one psum.  Batch-major ``(B, n_loc)`` contract."""
    hi = lax.Precision.HIGHEST
    lam_shift = lam + sigma2

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        delta = diag_fun(lam_shift) - base

        def op(v):
            t = lax.psum(jnp.matmul(v, U_loc, precision=hi), axis_name)  # (B, r)
            return base * v + jnp.matmul(t * delta[None, :], U_loc.T, precision=hi)

        return op

    return _apply(lambda s: 1.0 / s), _apply(lambda s: 1.0 / jnp.sqrt(s))


def _sharded_spectral_factor(U0_loc, weights, axis_name):
    """Row-sharded f32-robust spectral build (CholeskyQR2 + r×r congruence
    eigh — see :func:`gp_grief_jax.ops.precond.lowrank_spectral_factor`):
    the two r×r Gram reductions become psums; the tiny factorizations run
    replicated on every device."""
    with jax.default_matmul_precision("highest"):
        hi = lax.Precision.HIGHEST
        Ut = U0_loc
        Ls = []
        for _ in range(2):
            G = lax.psum(jnp.matmul(Ut.T, Ut, precision=hi), axis_name)
            L, _ = stable_cholesky(G)
            Ut = jax.scipy.linalg.solve_triangular(L, Ut.T, lower=True).T
            Ls.append(L)
        mid = jnp.matmul(Ls[1].T, Ls[0].T, precision=hi)
        mid = mid * jnp.sqrt(weights)[None, :]
        s, V = jnp.linalg.eigh(jnp.matmul(mid, mid.T, precision=hi))
        lam = jnp.maximum(s, 0.0)
        U_loc = jnp.matmul(Ut, V, precision=hi)
    return U_loc, lam


class ShardedGPSKIRegression(BaseModel):
    """Data-parallel :class:`~gp_grief_jax.models.gp_ski.GPSKIRegression`.

    Same estimator (deflation-preconditioned CG + whitened SLQ with BBMM
    stop-gradient surrogates), with the n-axis sharded over ``axis_name`` of
    ``mesh``: interpolation plans, solver state, and the preconditioner's
    skinny factor rows all live on their owning devices; the lattice and the
    O(r³)/O(k³) cores run replicated.  ``optimize()`` therefore trains
    data-parallel with gradients flowing through the collectives.
    """

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid=None,
        *,
        noise_var: float = 1.0,
        dim_noise_var: float = 0.0,
        mbar: int = 30,
        num_probes: int = 16,
        lanczos_iters: int = 40,
        cg_tol: float = 1e-8,
        cg_iters: int = 500,
        precond_rank: int = 256,
        solver: str = "data",
        wtw_stencil: bool = True,
        mesh: Optional[Mesh] = None,
        axis_name: str = "data",
        key=None,
    ):
        from gp_grief_jax.models.base import check_xy

        x, y = check_xy(x, y)
        x, y = np.asarray(x), np.asarray(y)
        if solver not in ("data", "lattice"):
            raise ValueError("solver must be 'data' or 'lattice'")
        self.solver = solver
        if grid is None:
            grid = InducingGrid.build(x, mbar=mbar)
        xg = grid.xg if isinstance(grid, InducingGrid) else grid
        self.xg = tuple(jnp.asarray(g, dtype=x.dtype) for g in xg)
        if any(g.ndim == 2 and g.shape[1] > 1 for g in self.xg):
            raise NotImplementedError(
                "multi-column (sub_dim > 1) grid dimensions are not supported by "
                "linear grid interpolation"
            )
        if solver == "lattice":
            from gp_grief_jax.models.gp_ski import warn_lattice_small_n

            warn_lattice_small_n(int(x.shape[0]), self.xg)
        self.mesh = mesh if mesh is not None else data_mesh(axis_name=axis_name)
        self.axis_name = axis_name
        n_dev = int(np.prod(self.mesh.devices.shape))
        xp, mask = pad_to_multiple(x, n_dev)
        yp, _ = pad_to_multiple(y, n_dev)
        self.n_real = int(x.shape[0])
        self.x, self.y = jnp.asarray(xp), jnp.asarray(yp)
        self.mask = jnp.asarray(mask)
        # Windowed applies when either gather source is big: the replicated (B, M) lattice for W, or a
        # shard's (B, n_loc) rows for Wᵀ.  Falls back to the flat stacked
        # plan when the windowed build declines (clustered data).
        m_total_ = int(np.prod([int(g.shape[0]) for g in self.xg]))
        self._wplan_st = (
            build_sharded_windowed_interp(xp, self.xg, n_dev)
            if max(m_total_, xp.shape[0] // n_dev) >= _WINDOWED_MIN_DIM
            else None
        )
        self._use_windowed = self._wplan_st is not None
        self._plan, self._sidx, self._sw = build_sharded_interp(
            xp, self.xg, n_dev, with_plan=not self._use_windowed
        )
        self._wtw_stencil = None
        if solver == "lattice":
            # Whitener shift from the REAL rows only (pad rows are masked out
            # of Ŵ, so diag(ŴᵀŴ) is the real-data mass² — the log-det
            # identity then assembles with n_real; see GPSKIRegression.
            from gp_grief_jax.models.gp_ski import lattice_cbar
            from gp_grief_jax.ops.interp import build_corner_stream, interp_weights
            from gp_grief_jax.ops.interp_stencil import build_wtw_stencil

            iw_real = interp_weights(jnp.asarray(x), self.xg)
            stream_real = build_corner_stream(iw_real)
            self._cbar = lattice_cbar(iw_real, stream=stream_real)
            if wtw_stencil:
                # ŴᵀŴ (real rows only — pad rows carry no corner updates) as
                # a replicated lattice stencil: the hot dual apply loses its
                # per-iteration psum AND both gather-bound point maps
                # (ops/interp_stencil.py).  Tables are replicated; the
                # builder self-gates on 3^d·M memory.
                self._wtw_stencil = build_wtw_stencil(iw_real, stream=stream_real)
        self.dim_noise_var = float(dim_noise_var)
        m_total = int(np.prod([int(g.shape[0]) for g in self.xg]))
        self._opts = dict(
            num_probes=num_probes, lanczos_iters=lanczos_iters,
            cg_tol=cg_tol, cg_iters=cg_iters,
            precond_rank=min(int(precond_rank), m_total, self.n_real),
        )
        self._key = jax.random.PRNGKey(0) if key is None else key
        kerns = (
            list(kern_list)
            if isinstance(kern_list, (list, tuple))
            else [kern_list] * len(self.xg)
        )
        # Working-dtype cast — same rationale (and int guard) as
        # GPSKIRegression: f64 kernel leaves under enable_x64 + f32 data
        # break solver scan carries.
        wdt = (
            self.x.dtype
            if jnp.issubdtype(self.x.dtype, jnp.floating)
            else jnp.result_type(float)
        )
        kerns = jax.tree.map(lambda a: jnp.asarray(a, dtype=wdt), kerns)
        self.params = {
            "kernels": kerns,
            "log_noise": inverse_positive(noise_var).astype(wdt),
        }

    # -- sharded pieces (all run INSIDE shard_map) ---------------------------

    def _plan_args(self):
        """(pytree, specs) of the active interpolation plan for shard_map
        argument lists — the windowed plan's array-field tuple, or the flat
        stacked :class:`InterpPlan`."""
        if self._use_windowed:
            return (
                _wplan_arrays(self._wplan_st),
                _wplan_arr_specs(self._wplan_st, self.axis_name),
            )
        return self._plan, _plan_specs(self.axis_name)

    def _resolve_plan(self, plan_st):
        """Local plan from the shard_map-sliced argument (either kind)."""
        if self._use_windowed:
            return _local_wplan(plan_st, self._wplan_st)
        return _local_plan(plan_st)

    # Interp application dispatch.  Windowed applies use the argument-
    # passing custom-VJP pair (adjoint = sibling direction → no scatter in
    # backward passes; tables flow as operands → no literal embedding when
    # gradients are lowered).
    @staticmethod
    def _w_apply(plan, u_lat_bm):
        """``W u``: replicated lattice ``(B, M)`` → local rows ``(B, n_loc)``
        in data order."""
        if isinstance(plan, WindowedPlan):
            arrays, statics = plan_split(plan)
            return matvec_sorted_p(statics, arrays, u_lat_bm)[:, plan.inv_perm]
        return interp_matvec_bm_fast(plan, u_lat_bm)

    @staticmethod
    def _wt_apply(plan, v_loc_bm):
        """``Wᵀ v``: local rows ``(B, n_loc)`` data order → ``(B, M)``
        (caller psums)."""
        if isinstance(plan, WindowedPlan):
            arrays, statics = plan_split(plan)
            return rmatvec_sorted_p(statics, arrays, v_loc_bm[:, plan.perm])
        return interp_rmatvec_bm_exact(plan, v_loc_bm)

    @staticmethod
    def _wtw_apply(plan, u_lat_bm, mk):
        """``Wᵀ(mask ∘ W u)`` — with a windowed plan the mask is applied in
        SORTED point order so the composition stays permutation-free."""
        if isinstance(plan, WindowedPlan):
            arrays, statics = plan_split(plan)
            mk_s = mk[plan.perm]
            t = matvec_sorted_p(statics, arrays, u_lat_bm) * mk_s[None, :]
            return rmatvec_sorted_p(statics, arrays, t)
        t = interp_matvec_bm_fast(plan, u_lat_bm) * mk[None, :]
        return interp_rmatvec_bm_exact(plan, t)

    def _mv_local(self, plan, mk, factors, sigma2):
        """Local block of ``Â = mask∘(W K Wᵀ)∘mask + σ²I``: ``(B, n_loc) →
        (B, n_loc)`` with one (B, M) psum (the lattice reduction)."""
        axis_name = self.axis_name

        def mv(v):
            B = v.shape[0]
            u = self._wt_apply(plan, v * mk[None, :])  # (B, M)
            u = lax.psum(u, axis_name)
            eyeB = jnp.eye(B, dtype=v.dtype)
            u = kron_matvec_fast((eyeB, *factors), u.reshape(-1)).reshape(B, -1)
            return self._w_apply(plan, u) * mk[None, :] + sigma2 * v

        return mv

    def _precond_factor_local(self, idx_loc, w_loc, mk, factors, r):
        """Sharded deflation FACTOR build: local ``U₀`` rows (masked),
        psum-reduced CholeskyQR2 + congruence eigh.  Returns ``(U_loc, lam)``
        — the rows this device owns plus the replicated spectrum — so the
        segmented paths can build it ONCE and thread it through bounded
        segment programs as an explicit argument."""
        with jax.default_matmul_precision("highest"):
            Qs, lams = kron_eigh(factors)
            log_lam, idx_top = top_p_kron_eigs(lams, r)
            lam_r = jnp.exp(log_lam)
            U0 = None
            for d_, Qd in enumerate(Qs):
                m_d = Qd.shape[0]
                i0 = idx_loc[d_]
                i1 = jnp.minimum(i0 + 1, m_d - 1)
                w2 = w_loc[d_]
                Pd = w2[:, 0:1] * Qd[i0, :] + w2[:, 1:2] * Qd[i1, :]
                col = Pd[:, idx_top[:, d_]]
                U0 = col if U0 is None else U0 * col
            U0 = U0 * mk[:, None]  # pad rows contribute nothing
        return _sharded_spectral_factor(U0, lam_r, self.axis_name)

    def _precond_ops_from_factor(self, U_loc, lam, sigma2, r):
        """Spectral ops + log-det from a (threaded or fresh) sharded factor."""
        M_inv, M_inv_sqrt = _sharded_lowrank_ops(U_loc, lam, sigma2, self.axis_name)
        n_pad = int(self.y.shape[0])
        logdet_M = jnp.sum(jnp.log(lam + sigma2)) + (n_pad - r) * jnp.log(sigma2)
        return M_inv, M_inv_sqrt, logdet_M

    def _precond_local(self, idx_loc, w_loc, mk, factors, sigma2, r):
        """Sharded deflation build: factor + spectral ops in one call (the
        monolithic paths)."""
        U_loc, lam = self._precond_factor_local(idx_loc, w_loc, mk, factors, r)
        return self._precond_ops_from_factor(U_loc, lam, sigma2, r)

    def _lattice_local_ops(self, plan, mk, factors, sigma2):
        """Sharded whitened-dual operators (see GPSKIRegression.
        _lattice_spectra): the lattice state ``(B, M)`` is REPLICATED on
        every device (spectra + Kron matvecs are identical local compute);
        only ``ŴᵀŴ`` crosses devices — one psum per application.  ``Ŵ = mask∘W``
        decouples pad rows exactly."""
        from gp_grief_jax.models.gp_kron import _clamp_psd, _lam_kron

        axis_name = self.axis_name
        cbar = self._cbar
        Qs, lams = kron_eigh(factors)
        lams = _clamp_psd(lams)
        lam = _lam_kron(lams)
        wjs = jnp.sqrt(lam / (sigma2 + cbar * lam))
        ld_MK = jnp.sum(jnp.log(sigma2 + cbar * lam))
        QsT = tuple(Q.T for Q in Qs)

        # Eigen-coordinate dual (see GPSKIRegression._make_lattice_ops):
        # the CG/SLQ state lives in Qᵀ-coordinates where the whitener is
        # diagonal — 2 Kron matvecs per white() instead of 4.
        prec = jax.lax.Precision.HIGHEST

        def to_dual(v_bm):
            B = v_bm.shape[0]
            eyeB = jnp.eye(B, dtype=v_bm.dtype)
            t = kron_matvec_fast(
                (eyeB, *QsT), v_bm.reshape(-1), precision=prec
            ).reshape(B, -1)
            return t * wjs[None, :]

        def from_dual(v_bm):
            B = v_bm.shape[0]
            # eyeB matches the CONTRACTED vector's (promoted) dtype — see
            # GPSKIRegression._make_lattice_ops.from_dual.
            t = (v_bm * wjs[None, :]).reshape(-1)
            eyeB = jnp.eye(B, dtype=t.dtype)
            return kron_matvec_fast(
                (eyeB, *Qs), t, precision=prec
            ).reshape(B, -1)

        if self._wtw_stencil is not None:
            from gp_grief_jax.ops.interp_stencil import wtw_stencil_bm

            stn = self._wtw_stencil

            def wtw(v_bm):
                # Replicated stencil: identical local compute, no collective
                # (the psum'd point-space form is the fallback below).
                return wtw_stencil_bm(stn, v_bm)

        else:

            def wtw(v_bm):
                return lax.psum(self._wtw_apply(plan, v_bm, mk), axis_name)

        def white(v_bm):
            u = from_dual(v_bm)
            return v_bm + to_dual(wtw(u) - cbar * u)

        def wt_masked(v_loc_bm):  # Ŵᵀ on local data rows → replicated (B, M)
            return lax.psum(
                self._wt_apply(plan, v_loc_bm * mk[None, :]), axis_name
            )

        return to_dual, from_dual, white, wt_masked, wtw, ld_MK

    def _loss_lattice(self, params):
        """Sharded lattice-dual NLML — the GPSKIRegression._loss_lattice
        estimator with ŴᵀŴ psum-coupled and everything else replicated.
        SLQ/gradient probes are lattice vectors drawn from the SAME key on
        every device, so the estimator is identical to the single-device one
        (tested to ~1e-12)."""
        o = self._opts
        n_real = self.n_real
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        axis_name = self.axis_name
        key = self._key

        def local(y_loc, mk, plan_st):
            plan = self._resolve_plan(plan_st)
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            to_dual, _, white, wt_masked, _, ld_MK = self._lattice_local_ops(
                plan, mk, factors, sigma2
            )
            vt = to_dual(wt_masked(y_loc[None, :]))
            z = jax.random.rademacher(key, (o["num_probes"], M), dtype=y_loc.dtype)
            sol = cg_solve(
                white, jnp.concatenate([vt, z], axis=0), tol=o["cg_tol"],
                max_iters=o["cg_iters"], layout="bm", implicit_diff=False,
            )
            gam = lax.stop_gradient(sol[0])
            S = lax.stop_gradient(sol[1:])
            yy = lax.psum(jnp.dot(y_loc, y_loc), axis_name)
            quad = (
                yy - 2.0 * jnp.dot(vt[0], gam) + jnp.dot(gam, white(gam[None, :])[0])
            ) / sigma2
            ld_white = lax.stop_gradient(
                slq_logdet(
                    white, M, key=jax.random.fold_in(key, 1),
                    num_probes=o["num_probes"],
                    lanczos_iters=o["lanczos_iters"], dtype=y_loc.dtype,
                    layout="bm",
                )
            )
            g_sur = jnp.sum(S * white(z)) / o["num_probes"]
            ld = (
                (n_real - M) * params["log_noise"]
                + ld_MK
                + ld_white
                + g_sur
                - lax.stop_gradient(g_sur)
            )
            return 0.5 * (quad + ld + n_real * jnp.log(2.0 * jnp.pi))

        an = axis_name
        plan_arg, plan_spec = self._plan_args()
        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(an), P(an), plan_spec),
            out_specs=P(),
            check_vma=False,
        )(self.y, self.mask, plan_arg)

    def _loss(self, params):
        if self.solver == "lattice":
            return self._loss_lattice(params)
        o = self._opts
        n_real, n_pad = self.n_real, int(self.y.shape[0])
        axis_name = self.axis_name
        r = o["precond_rank"]
        key = self._key

        def local(y_loc, mk, plan_st, idx_st, w_st):
            plan = self._resolve_plan(plan_st)
            idx_loc = tuple(a[0] for a in idx_st)
            w_loc = tuple(a[0] for a in w_st)
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            mv = self._mv_local(plan, mk, factors, sigma2)
            if r > 0:
                M_inv, M_inv_sqrt, ld_M = self._precond_local(
                    idx_loc, w_loc, mk, factors, sigma2, r
                )
            else:
                M_inv = M_inv_sqrt = None
                ld_M = 0.0

            # Gradient-surrogate probes are MASKED (pad rows zero) so the
            # Hutchinson trace estimates ∂log|A_real| directly — the masked
            # congruence block-decouples pad rows.
            zkey = jax.random.fold_in(
                jax.random.fold_in(key, 7), lax.axis_index(axis_name)
            )
            z = (
                jax.random.rademacher(
                    zkey, (o["num_probes"], y_loc.shape[0]), dtype=y_loc.dtype
                )
                * mk[None, :]
            )
            rhs = jnp.concatenate([y_loc[None, :], z], axis=0)
            if M_inv_sqrt is not None:
                # Whitened-basis solve — data-space PCG freezes whenever
                # σ² < ε_f32·λmax; same as gp_ski.
                solw = cg_solve(
                    lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv))),
                    M_inv_sqrt(rhs), tol=o["cg_tol"],
                    max_iters=o["cg_iters"], layout="bm",
                    implicit_diff=False, axis_name=axis_name,
                )
                sol = M_inv_sqrt(solw)
            else:
                sol = cg_solve(
                    mv, rhs, tol=o["cg_tol"], max_iters=o["cg_iters"],
                    layout="bm", implicit_diff=False, axis_name=axis_name,
                )
            alpha = lax.stop_gradient(sol[0])
            S = lax.stop_gradient(sol[1:])

            quad = lax.psum(
                2.0 * jnp.dot(y_loc, alpha) - jnp.dot(alpha, mv(alpha[None, :])[0]),
                axis_name,
            )
            # Whitened SLQ on the padded operator; pad rows whiten to exact 1
            # (contribute log 1 = 0) and the −(n_pad−n)·log σ² correction
            # removes their unwhitened σ² block from the value.
            if M_inv_sqrt is not None:
                slq_mv = lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))  # noqa: E731
                ld_off = ld_M
            else:
                slq_mv, ld_off = mv, 0.0
            ld_val = lax.stop_gradient(
                ld_off
                + slq_logdet(
                    slq_mv, y_loc.shape[0], key=jax.random.fold_in(key, 1),
                    num_probes=o["num_probes"],
                    lanczos_iters=o["lanczos_iters"], dtype=y_loc.dtype,
                    layout="bm", axis_name=axis_name,
                )
                - (n_pad - n_real) * params["log_noise"]
            )
            g_sur = lax.psum(jnp.sum(S * mv(z)), axis_name) / o["num_probes"]
            ld = ld_val + g_sur - lax.stop_gradient(g_sur)
            return 0.5 * (quad + ld + n_real * jnp.log(2.0 * jnp.pi))

        an = axis_name
        plan_arg, plan_spec = self._plan_args()
        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(an), P(an), plan_spec,
                      tuple(P(an, None) for _ in self._sidx),
                      tuple(P(an, None, None) for _ in self._sw)),
            out_specs=P(),
            check_vma=False,
        )(self.y, self.mask, plan_arg, self._sidx, self._sw)

    # -- segmented (bounded-program) evaluation + training ------------------

    def _wrap_sharded_program(self, fn, in_specs, out_specs):
        """``jit(shard_map(fn))`` with closure-captured arrays HOISTED into
        explicit device-buffer arguments on first call (lazy — the example
        shapes come from the first real arguments).

        Why: the lattice bodies close over ``self._wtw_stencil`` — 3^d·M
        tables ≈ 324 MB at the 1M/32⁴ scale — and a bound ``jax.jit`` would
        bake them into every lowered program as constants (the
        utils/closure rule)."""
        from gp_grief_jax.utils.closure import explicit_closure

        sm = shard_map(
            fn, mesh=self.mesh, in_specs=in_specs,
            out_specs=out_specs, check_vma=False,
        )
        box = {}

        def call(*args):
            if "prog" not in box:
                sds = jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(
                        jnp.shape(a), jnp.result_type(a)
                    ),
                    args,
                )
                pure, consts = explicit_closure(sm, *sds)
                box["prog"] = (jax.jit(pure), consts)
            prog, consts = box["prog"]
            return prog(consts, *args)

        return call

    def _seg_programs(self, segment_iters: int, B: int):
        """Compile-once sharded (init, segment, finish, slq) programs for the
        segmented NLML/training paths (cached per geometry).

        ``B``: solver-state batch rows — 1 for the NLML quadratic solve,
        ``1+R`` for a training step's fused y+probe solves.  Solver state
        stays DEVICE-RESIDENT between dispatches with its natural sharding
        (data-space state rows sharded over ``axis_name``; lattice-dual state
        replicated), and the data-space deflation factor is built once in
        ``init`` and threaded through every later program as an explicit
        sharded argument — so each program is bounded at ``segment_iters``
        CG iterations or one probe chunk (round-3 missing #4)."""
        key_t = (int(segment_iters), int(B))
        cache = getattr(self, "_seg_progs_cache", None)
        if cache is None:
            cache = self._seg_progs_cache = {}
        if key_t in cache:
            return cache[key_t]
        from gp_grief_jax.ops.cg import _make_pcg_step, _reducers

        an = self.axis_name
        o = self._opts
        lattice = self.solver == "lattice"
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        n_pad = int(self.y.shape[0])
        n_real = self.n_real
        r = 0 if lattice else int(o["precond_rank"])
        plan_arg, plan_spec = self._plan_args()
        param_specs = jax.tree.map(lambda _: P(), self.params)
        n_loc = n_pad // int(np.prod(self.mesh.devices.shape))

        if lattice:
            _colsum, _colnorm, _bc = _reducers("bm", None)

            def _ops(params, mk, plan):
                sigma2 = jnp.exp(params["log_noise"])
                factors = cov_grid(
                    params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
                )
                return sigma2, self._lattice_local_ops(plan, mk, factors, sigma2)

            def init_local(params, key, y_loc, mk, plan_st):
                plan = self._resolve_plan(plan_st)
                _, (to_dual, _, _, wt_masked, _, _) = _ops(params, mk, plan)
                vt = to_dual(wt_masked(y_loc[None, :]))
                z = jax.random.rademacher(key, (B - 1, M), dtype=y_loc.dtype)
                rhs = jnp.concatenate([vt, z], axis=0) if B > 1 else vt
                x0 = jnp.zeros_like(rhs)
                rz0 = _colsum(rhs * rhs)
                state = (x0, rhs, rhs, rhs, rz0, jnp.zeros(rz0.shape, bool))
                return state, _colnorm(rhs), z

            def seg_local(params, state, mk, plan_st):
                plan = self._resolve_plan(plan_st)
                _, (_, _, white, _, _, _) = _ops(params, mk, plan)
                step = _make_pcg_step(white, lambda rr_: rr_, _colsum, _bc)
                state, _ = lax.scan(
                    lambda s, _: (step(*s), None), state, None,
                    length=segment_iters,
                )
                return state, _colnorm(state[1]), state[5]

            def fin_local(params, state, y_loc, mk, plan_st):
                plan = self._resolve_plan(plan_st)
                sigma2, (to_dual, _, white, wt_masked, _, ld_MK) = _ops(
                    params, mk, plan
                )
                gam = state[0]
                yy = lax.psum(jnp.dot(y_loc, y_loc), an)
                vt = to_dual(wt_masked(y_loc[None, :]))  # cheap recompute
                quad = (
                    yy
                    - 2.0 * jnp.dot(vt[0], gam[0])
                    + jnp.dot(gam[0], white(gam[:1])[0])
                ) / sigma2
                return quad, sigma2, ld_MK, state[0]

            def make_slq(rr):
                def slq_local(params, key, mk, plan_st):
                    plan = self._resolve_plan(plan_st)
                    _, (_, _, white, _, _, _) = _ops(params, mk, plan)
                    return slq_logdet(
                        white, M, key=key, num_probes=rr,
                        lanczos_iters=int(o["lanczos_iters"]),
                        dtype=self.y.dtype, layout="bm",
                    )

                return slq_local

            st_spec = (P(), P(), P(), P(), P(), P())
            init_in = (param_specs, P(), P(an), P(an), plan_spec)
            init_out = (st_spec, P(), P())
            seg_in = (param_specs, st_spec, P(an), plan_spec)
            seg_out = (st_spec, P(), P())
            fin_in = (param_specs, st_spec, P(an), P(an), plan_spec)
            fin_out = (P(), P(), P(), P())
            slq_in = (param_specs, P(), P(an), plan_spec)
        else:
            _colsum, _colnorm, _bc = _reducers("bm", an)

            def _mv_and_white(params, mk, plan, U_loc, lam):
                sigma2 = jnp.exp(params["log_noise"])
                factors = cov_grid(
                    params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
                )
                mv = self._mv_local(plan, mk, factors, sigma2)
                if r > 0:
                    _, M_inv_sqrt, ld_M = self._precond_ops_from_factor(
                        U_loc, lam, sigma2, r
                    )
                    return (
                        mv,
                        lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv))),
                        M_inv_sqrt,
                        ld_M,
                        sigma2,
                    )
                return mv, mv, (lambda vv: vv), jnp.zeros((), self.y.dtype), sigma2

            def init_local(params, key, y_loc, mk, plan_st, idx_st, w_st):
                plan = self._resolve_plan(plan_st)
                factors = cov_grid(
                    params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
                )
                if r > 0:
                    U_loc, lam = self._precond_factor_local(
                        tuple(a[0] for a in idx_st), tuple(a[0] for a in w_st),
                        mk, factors, r,
                    )
                else:
                    U_loc = jnp.zeros((y_loc.shape[0], 0), self.y.dtype)
                    lam = jnp.zeros((0,), self.y.dtype)
                _, _, M_inv_sqrt, _, _ = _mv_and_white(params, mk, plan, U_loc, lam)
                zkey = jax.random.fold_in(
                    jax.random.fold_in(key, 7), lax.axis_index(an)
                )
                z = (
                    jax.random.rademacher(
                        zkey, (B - 1, y_loc.shape[0]), dtype=y_loc.dtype
                    )
                    * mk[None, :]
                )
                rhs = jnp.concatenate([y_loc[None, :], z], axis=0)
                rhs = M_inv_sqrt(rhs)
                x0 = jnp.zeros_like(rhs)
                rz0 = _colsum(rhs * rhs)
                state = (x0, rhs, rhs, rhs, rz0, jnp.zeros(rz0.shape, bool))
                return state, _colnorm(rhs), z, U_loc, lam

            def seg_local(params, state, mk, plan_st, U_loc, lam):
                plan = self._resolve_plan(plan_st)
                _, white, _, _, _ = _mv_and_white(params, mk, plan, U_loc, lam)
                step = _make_pcg_step(white, lambda rr_: rr_, _colsum, _bc)
                state, _ = lax.scan(
                    lambda s, _: (step(*s), None), state, None,
                    length=segment_iters,
                )
                return state, _colnorm(state[1]), state[5]

            def fin_local(params, state, y_loc, mk, plan_st, U_loc, lam):
                plan = self._resolve_plan(plan_st)
                mv, _, M_inv_sqrt, ld_M, sigma2 = _mv_and_white(
                    params, mk, plan, U_loc, lam
                )
                sol = M_inv_sqrt(state[0])  # (B, n_loc) data-space solutions
                alpha = sol[:1]
                quad = lax.psum(
                    2.0 * jnp.dot(y_loc, alpha[0]) - jnp.dot(alpha[0], mv(alpha)[0]),
                    an,
                )
                ld_off = ld_M - (n_pad - n_real) * params["log_noise"]
                return quad, ld_off, sol

            def make_slq(rr):
                def slq_local(params, key, mk, plan_st, U_loc, lam):
                    plan = self._resolve_plan(plan_st)
                    _, white, _, _, _ = _mv_and_white(params, mk, plan, U_loc, lam)
                    return slq_logdet(
                        white, n_loc, key=key, num_probes=rr,
                        lanczos_iters=int(o["lanczos_iters"]),
                        dtype=self.y.dtype, layout="bm", axis_name=an,
                    )

                return slq_local

            sharded_bm = P(None, an)
            st_spec = (sharded_bm,) * 4 + (P(), P())
            idx_specs = tuple(P(an, None) for _ in self._sidx)
            w_specs = tuple(P(an, None, None) for _ in self._sw)
            init_in = (param_specs, P(), P(an), P(an), plan_spec, idx_specs, w_specs)
            init_out = (st_spec, P(), sharded_bm, P(an, None), P())
            seg_in = (param_specs, st_spec, P(an), plan_spec, P(an, None), P())
            seg_out = (st_spec, P(), P())
            fin_in = (param_specs, st_spec, P(an), P(an), plan_spec, P(an, None), P())
            fin_out = (P(), P(), sharded_bm)
            slq_in = (param_specs, P(), P(an), plan_spec, P(an, None), P())

        _wrap = self._wrap_sharded_program

        cache[key_t] = (
            _wrap(init_local, init_in, init_out),
            _wrap(seg_local, seg_in, seg_out),
            _wrap(fin_local, fin_in, fin_out),
            {"make": make_slq, "wrap": _wrap, "in": slq_in, "progs": {}},
            plan_arg,
        )
        return cache[key_t]

    def _slq_prog(self, slq_cache, rr: int):
        """SLQ chunk program for ``rr`` probes (built on first use, cached)."""
        if rr not in slq_cache["progs"]:
            slq_cache["progs"][rr] = slq_cache["wrap"](
                slq_cache["make"](rr), slq_cache["in"], P()
            )
        return slq_cache["progs"][rr]

    def _run_segmented_solve(
        self, progs, params, key, cg_segment_iters, verbose=False, tag=""
    ):
        """Init + host-segmented CG loop shared by the NLML and training
        paths.  Returns ``(state, aux)`` where ``aux`` carries the solver's
        threaded extras (probes; data-space deflation factor)."""
        init_fn, seg_fn, _, _, plan_arg = progs
        o = self._opts
        lattice = self.solver == "lattice"
        if lattice:
            out = init_fn(params, key, self.y, self.mask, plan_arg)
            state, bnorm, z = out
            aux = (z,)
            seg_args = lambda st: (params, st, self.mask, plan_arg)  # noqa: E731
        else:
            out = init_fn(
                params, key, self.y, self.mask, plan_arg, self._sidx, self._sw
            )
            state, bnorm, z, U, lam = out
            aux = (z, U, lam)
            seg_args = lambda st: (params, st, self.mask, plan_arg, U, lam)  # noqa: E731
        eff_tol = max(float(o["cg_tol"]), 20.0 * float(jnp.finfo(self.y.dtype).eps))
        stop = eff_tol * np.maximum(
            np.asarray(bnorm), float(jnp.finfo(self.y.dtype).tiny)
        )
        rnorm_h = np.asarray(bnorm)
        dead_h = np.zeros(rnorm_h.shape, bool)
        max_segments = max(1, -(-int(o["cg_iters"]) // int(cg_segment_iters)))
        for s in range(max_segments):
            if not np.any((rnorm_h > stop) & ~dead_h):
                break
            prev = rnorm_h
            state, rnorm, dead = seg_fn(*seg_args(state))
            # Per-segment fetch = host convergence test + bounds the device
            # queue at one segment.
            rnorm_h, dead_h = np.asarray(rnorm), np.asarray(dead)
            if verbose:
                rel = float(np.max(rnorm_h / np.maximum(np.asarray(bnorm), 1e-30)))
                print(f"[{tag}] segment {s + 1}: max_rel_resid={rel:.3e}", flush=True)
            # Stagnation brake (same rationale as GPSKIRegression).
            if not np.any(rnorm_h < prev / 1.2):
                break
        return state, aux

    def log_likelihood_segmented(
        self,
        *,
        cg_segment_iters: int = 60,
        probe_chunk: int = 8,
        verbose: bool = False,
    ) -> float:
        """Host-segmented sharded NLML — the same estimator as
        :meth:`log_likelihood` (identical psum-coupled CG recurrence and
        whitened/lattice SLQ; the probe draw is chunk-partitioned, so the
        two agree within SLQ sampling error, exactly when whitening is
        complete), with no single device program running more than
        ``cg_segment_iters`` CG iterations or one SLQ probe chunk
        (capability parity with the single-device models, SURVEY §2's
        parallelism table).  Value-only."""
        o = self._opts
        lattice = self.solver == "lattice"
        n_real = self.n_real
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        progs = self._seg_programs(int(cg_segment_iters), 1)
        _, _, fin_fn, slq_cache, plan_arg = progs
        state, aux = self._run_segmented_solve(
            progs, self.params, self._key, cg_segment_iters,
            verbose=verbose, tag="sharded_nlml_segmented",
        )
        probe_chunk = max(1, min(int(probe_chunk), int(o["num_probes"])))
        sizes = [probe_chunk] * (int(o["num_probes"]) // probe_chunk)
        if int(o["num_probes"]) % probe_chunk:
            sizes.append(int(o["num_probes"]) % probe_chunk)
        key1 = jax.random.fold_in(self._key, 1)
        total = 0.0
        if lattice:
            quad, sigma2, ld_MK, _sol = fin_fn(
                self.params, state, self.y, self.mask, plan_arg
            )
            for c, rr in enumerate(sizes):
                sp = self._slq_prog(slq_cache, rr)
                total += float(
                    sp(self.params, jax.random.fold_in(key1, c), self.mask, plan_arg)
                ) * rr
            ld_white = total / int(o["num_probes"])
            ld = (n_real - M) * float(np.log(float(sigma2))) + float(ld_MK) + ld_white
            quad = float(quad)
        else:
            _, U, lam = aux
            quad, ld_off, _sol = fin_fn(
                self.params, state, self.y, self.mask, plan_arg, U, lam
            )
            for c, rr in enumerate(sizes):
                sp = self._slq_prog(slq_cache, rr)
                total += float(
                    sp(
                        self.params, jax.random.fold_in(key1, c), self.mask,
                        plan_arg, U, lam,
                    )
                ) * rr
            ld = float(ld_off) + total / int(o["num_probes"])
            quad = float(quad)
        return -0.5 * (quad + ld + n_real * float(np.log(2.0 * np.pi)))

    def optimize_segmented(
        self,
        *,
        max_iters: int = 30,
        learning_rate: float = 0.05,
        num_probes: int = 4,
        cg_segment_iters: int = 50,
        verbose: bool = False,
    ):
        """Data-parallel Adam training with bounded-program steps — the
        sharded port of :meth:`GPSKIRegression.optimize_segmented`: per step
        the y+probe solves run host-segmented (device-resident sharded
        state), then ONE bounded sharded program autodiffs the BBMM
        surrogate with the solves injected as fixed inputs (the same
        gradient as ``jax.grad(self._loss)`` with matching probe draws), and
        the Adam update runs on host.  The returned ``losses`` trace is the
        surrogate objective; use :meth:`log_likelihood_segmented` for true
        NLML."""
        import time as _time

        import optax

        an = self.axis_name
        o = self._opts
        n_real = self.n_real
        n_pad = int(self.y.shape[0])
        M = int(np.prod([int(g.shape[0]) for g in self.xg]))
        R = int(num_probes)
        lattice = self.solver == "lattice"
        progs = self._seg_programs(int(cg_segment_iters), 1 + R)
        _, _, fin_fn, _, plan_arg = progs
        param_specs = jax.tree.map(lambda _: P(), self.params)
        plan_spec = self._plan_args()[1]

        def surrogate_local(params, sol, z, y_loc, mk, plan_st):
            plan = self._resolve_plan(plan_st)
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            if lattice:
                to_dual, _, white, wt_masked, _, ld_MK = self._lattice_local_ops(
                    plan, mk, factors, sigma2
                )
                vt = to_dual(wt_masked(y_loc[None, :]))
                gam, S = sol[0], sol[1:]
                yy = lax.psum(jnp.dot(y_loc, y_loc), an)
                quad = (
                    yy - 2.0 * jnp.dot(vt[0], gam)
                    + jnp.dot(gam, white(gam[None, :])[0])
                ) / sigma2
                g_sur = jnp.sum(S * white(z)) / R
                ld_part = (n_real - M) * params["log_noise"] + ld_MK + g_sur
            else:
                mv = self._mv_local(plan, mk, factors, sigma2)
                alpha, S = sol[:1], sol[1:]
                quad = lax.psum(
                    2.0 * jnp.dot(y_loc, alpha[0])
                    - jnp.dot(alpha[0], mv(alpha)[0]),
                    an,
                )
                g_sur = lax.psum(jnp.sum(S * mv(z)), an) / R
                ld_part = g_sur
            return 0.5 * (quad + ld_part + n_real * jnp.log(2.0 * jnp.pi))

        if lattice:
            sur_in = (param_specs, P(), P(), P(an), P(an), plan_spec)
        else:
            sur_in = (param_specs, P(None, an), P(None, an), P(an), P(an), plan_spec)
        if getattr(self, "_seg_vg_key", None) != (R, lattice):
            from gp_grief_jax.utils.closure import explicit_closure

            sur = shard_map(
                surrogate_local, mesh=self.mesh, in_specs=sur_in,
                out_specs=P(), check_vma=False,
            )

            def vg_fn(p, sol, z, y, mk, pa):
                return jax.value_and_grad(
                    lambda pp: sur(pp, sol, z, y, mk, pa)
                )(p)

            # Lazy explicit_closure (see _wrap_sharded_program): the lattice
            # surrogate closes over the WtW stencil tables.
            box = {}

            def vg_call(*args):
                if "prog" not in box:
                    sds = jax.tree.map(
                        lambda a: jax.ShapeDtypeStruct(
                            jnp.shape(a), jnp.result_type(a)
                        ),
                        args,
                    )
                    pure, consts = explicit_closure(vg_fn, *sds)
                    box["prog"] = (jax.jit(pure), consts)
                prog, consts = box["prog"]
                return prog(consts, *args)

            self._seg_vg_key = (R, lattice)
            self._seg_vg = vg_call
        vg = self._seg_vg

        opt = optax.adam(learning_rate)
        opt_state = opt.init(self.params)
        losses = []
        t0 = _time.perf_counter()
        for it in range(max_iters):
            key_t = jax.random.fold_in(self._key, 1000 + it)
            state, aux = self._run_segmented_solve(
                progs, self.params, key_t, cg_segment_iters,
                tag="sharded_optimize_segmented",
            )
            if lattice:
                (z,) = aux
                _, _, _, sol = fin_fn(
                    self.params, state, self.y, self.mask, plan_arg
                )
            else:
                z, U, lam = aux
                _, _, sol = fin_fn(
                    self.params, state, self.y, self.mask, plan_arg, U, lam
                )
            val, grad = vg(self.params, sol, z, self.y, self.mask, plan_arg)
            losses.append(float(val))
            updates, opt_state = opt.update(grad, opt_state, self.params)
            self.params = optax.apply_updates(self.params, updates)
            if verbose:
                print(
                    f"[sharded_optimize_segmented] iter {it + 1:3d} "
                    f"surrogate {losses[-1]:.4f}",
                    flush=True,
                )
        from gp_grief_jax.optimize import FitResult

        return FitResult(
            params=self.params,
            losses=np.asarray(losses),
            grad_norms=np.full(len(losses), np.nan),
            iterations=len(losses),
            wall_time=_time.perf_counter() - t0,
            converged=False,
        )

    # -- prediction ----------------------------------------------------------

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False,
                chunk: int = 2048):
        """Predictive mean (and exact variance) at test points (replicated).

        One sharded program computes ``K (Wᵀ α)`` (lattice vector) and, per
        test chunk, the cross-covariance rows + a sharded CG solve for the
        variance quadratic form — the same host-chunked structure as the
        single-device model (test points are never sharded; only the n-axis
        work is).
        """
        from gp_grief_jax.models.gp_ski import GPSKIRegression
        from gp_grief_jax.ops.interp import interp_matvec, interp_rmatvec_bm

        x_new = jnp.asarray(x_new, dtype=self.x.dtype)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = np.zeros((0,), dtype=np.asarray(self.y).dtype)
            return empty if not compute_var else (empty, empty.copy())
        chunk = max(1, min(chunk, n_star))
        n_c = -(-n_star // chunk) * chunk
        x_pad = (
            jnp.concatenate(
                [x_new, jnp.broadcast_to(x_new[:1], (n_c - n_star, x_new.shape[1]))]
            )
            if n_c != n_star
            else x_new
        )
        an = self.axis_name
        o = self._opts
        r = o["precond_rank"]

        def _local_solver(plan, mk, idx_st, w_st, factors, sigma2):
            """Data-space solve closure (solver='data' paths only: the
            lattice branches below never leave the dual — the data-space
            correction ``(r − corr)/σ²`` cancels catastrophically at f32
            when σ² ≪ κ(K̂)·ε, same as the single-device model)."""
            mv = self._mv_local(plan, mk, factors, sigma2)
            if r > 0:
                _, M_inv_sqrt, _ = self._precond_local(
                    tuple(a[0] for a in idx_st), tuple(a[0] for a in w_st),
                    mk, factors, sigma2, r,
                )

                def solve(rhs_bm):
                    # Whitened-basis solve — see _loss.
                    solw = cg_solve(
                        lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv))),
                        M_inv_sqrt(rhs_bm), tol=o["cg_tol"],
                        max_iters=o["cg_iters"], layout="bm",
                        implicit_diff=False, axis_name=an,
                    )
                    return M_inv_sqrt(solw)

                return solve
            return lambda rhs_bm: cg_solve(
                mv, rhs_bm, tol=o["cg_tol"], max_iters=o["cg_iters"],
                layout="bm", implicit_diff=False, axis_name=an,
            )

        # params is an explicit argument (replicated spec) so the cached
        # compiled programs track parameter updates — a closure would bake
        # the construction-time values in (round-2 review finding).
        def prep_local(params, y_loc, mk, plan_st, idx_st, w_st):
            plan = self._resolve_plan(plan_st)
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            if self.solver == "lattice":
                # Dual mean representer: K Wᵀ Â⁻¹ y ≡ B⁻¹(Ŵᵀy) — see
                # GPSKIRegression.predict (no σ² division, bounded whitened
                # CG).  Replicated apart from the psums inside the ops.
                to_dual, from_dual, white, wt_masked, _, _ = (
                    self._lattice_local_ops(plan, mk, factors, sigma2)
                )
                gam = cg_solve(
                    white, to_dual(wt_masked(y_loc[None, :])), tol=o["cg_tol"],
                    max_iters=o["cg_iters"], layout="bm", implicit_diff=False,
                )
                return from_dual(gam)[0]
            solve = _local_solver(plan, mk, idx_st, w_st, factors, sigma2)
            alpha = solve(y_loc[None, :])[0]
            Wt_a = lax.psum(
                self._wt_apply(plan, (alpha * mk)[None, :])[0], an
            )
            Kw_alpha = kron_matvec_fast(factors, Wt_a)
            return Kw_alpha

        def var_local(params, y_loc, mk, plan_st, idx_st, w_st, u_bm):
            # u_bm (c, M) replicated: K Wᵀ* rows of the test chunk for
            # solver='data'; the RAW test interp rows W*ᵀ for 'lattice'.
            plan = self._resolve_plan(plan_st)
            sigma2 = jnp.exp(params["log_noise"])
            factors = cov_grid(
                params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
            )
            if self.solver == "lattice":
                # Exact variance reduction in the dual:
                # c_tᵀÂ⁻¹c_t ≡ w*ᵀ K (ŴᵀŴ) B⁻¹ w* — see GPSKIRegression.
                to_dual, from_dual, white, _, wtw, _ = (
                    self._lattice_local_ops(plan, mk, factors, sigma2)
                )
                gam = cg_solve(
                    white, to_dual(u_bm), tol=o["cg_tol"],
                    max_iters=o["cg_iters"], layout="bm", implicit_diff=False,
                )
                Ggam = wtw(from_dual(gam))  # (c, M)
                c = u_bm.shape[0]
                eyeC = jnp.eye(c, dtype=u_bm.dtype)
                KG = kron_matvec_fast(
                    (eyeC, *factors), Ggam.reshape(-1)
                ).reshape(c, -1)
                return jnp.sum(u_bm * KG, axis=1)  # (c,)
            solve = _local_solver(plan, mk, idx_st, w_st, factors, sigma2)
            C_loc = self._w_apply(plan, u_bm) * mk[None, :]  # (c, n_loc)
            Sol = solve(C_loc)
            return lax.psum(jnp.sum(C_loc * Sol, axis=1), an)  # (c,)

        param_specs = jax.tree.map(lambda _: P(), self.params)
        plan_arg, plan_spec = self._plan_args()
        plan_in = (param_specs, P(an), P(an), plan_spec,
                   tuple(P(an, None) for _ in self._sidx),
                   tuple(P(an, None, None) for _ in self._sw))
        if not hasattr(self, "_predict_progs") or self._predict_progs[0] != chunk:
            # Hoisted-capture wrapper (stencil tables — see
            # _wrap_sharded_program); same rule as the segmented paths.
            prep = self._wrap_sharded_program(prep_local, plan_in, P())
            varp = self._wrap_sharded_program(var_local, plan_in + (P(),), P())
            self._predict_progs = (chunk, prep, varp)
        _, prep, varp = self._predict_progs

        Kw_alpha = prep(self.params, self.y, self.mask, plan_arg, self._sidx, self._sw)
        factors = cov_grid(
            self.params["kernels"], self.xg, dim_noise_var=self.dim_noise_var
        )
        sigma2 = float(jnp.exp(self.params["log_noise"]))
        means, vars_ = [], []
        for i in range(0, n_c, chunk):
            xc = x_pad[i : i + chunk]
            iw_c = interp_weights(xc, self.xg)
            means.append(np.asarray(interp_matvec(iw_c, Kw_alpha)))
            if compute_var:
                c = int(xc.shape[0])
                Wst = interp_rmatvec_bm(iw_c, jnp.eye(c, dtype=self.x.dtype))
                if self.solver == "lattice":
                    u = Wst  # the dual form consumes the raw interp rows
                else:
                    eyeC = jnp.eye(c, dtype=self.x.dtype)
                    u = kron_matvec_fast(
                        (eyeC, *factors), Wst.reshape(-1)
                    ).reshape(c, -1)
                qf = varp(self.params, self.y, self.mask, plan_arg, self._sidx, self._sw, u)
                prior = GPSKIRegression._prior_diag(factors, iw_c)
                vars_.append(np.maximum(np.asarray(prior) - np.asarray(qf), 0.0))
        mean = np.concatenate(means)[:n_star]
        if not compute_var:
            return mean
        var = np.concatenate(vars_)[:n_star]
        if include_noise:
            var = var + sigma2
        return mean, var
