"""ShardedGPGriefModel: the GP-GRIEF model trained data-parallel over a mesh.

Model-level wrapper around ``parallel.sharded`` (SURVEY.md §2 parallelism
table): training rows live sharded across the ``data`` axis of a
``jax.sharding.Mesh``; every NLML evaluation computes local ``Φ_k`` blocks and
``psum``-reduces the p×p / p statistics across devices, then the O(p³) core
runs replicated.  Gradients flow through the collectives, so ``optimize()``
is the same optax loop as the single-device model.  Prediction gathers nothing — it
uses the replicated basis + posterior.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax.grid import InducingGrid
from gp_grief_jax.kernels.grief import build_basis, phi
from gp_grief_jax.kernels.stationary import Stationary
from gp_grief_jax.models.base import BaseModel, basis_nlml, basis_posterior
from gp_grief_jax.models.gp_grief import init_grief_state
from gp_grief_jax.parallel.mesh import data_mesh
from gp_grief_jax.parallel.sharded import pad_to_multiple, sharded_basis_stats

__all__ = ["ShardedGPGriefModel"]


class ShardedGPGriefModel(BaseModel):
    """Data-parallel GP-GRIEF (API-compatible with :class:`GPGriefModel`).

    Differences: data is zero-padded to the mesh size with a row mask; the
    basis is always rebuilt inside the objective (opt_kernel_params semantics)
    since the sharded reduction re-runs anyway; ``mesh`` defaults to a 1-D
    data mesh over all visible devices.
    """

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid: Optional[InducingGrid] = None,
        *,
        n_eigs: int = 100,
        noise_var: float = 1.0,
        dim_noise_var: float = 1e-12,
        mbar: int = 10,
        mesh=None,
        axis_name: str = "data",
        dtype=None,
    ):
        x_j, y_j, grid, self.xg, self.n_eigs, self.dims, self.params = init_grief_state(
            x, y, kern_list, grid, n_eigs, noise_var, mbar, dtype
        )
        self.grid = grid
        self.mesh = mesh if mesh is not None else data_mesh(axis_name=axis_name)
        self.axis_name = axis_name
        n_dev = int(np.prod(self.mesh.devices.shape))
        xp, mask = pad_to_multiple(np.asarray(x_j), n_dev)
        yp, _ = pad_to_multiple(np.asarray(y_j), n_dev)
        self.n_real = x_j.shape[0]
        self.x, self.y = jnp.asarray(xp), jnp.asarray(yp)
        self.mask = jnp.asarray(mask)
        self.dim_noise_var = float(dim_noise_var)

    def _build_and_stats(self, params):
        basis = build_basis(
            params["kernels"], self.xg, self.n_eigs, dim_noise_var=self.dim_noise_var
        )
        stats = sharded_basis_stats(
            basis, params["kernels"], self.xg, self.x, self.y, self.mask,
            self.mesh, axis_name=self.axis_name, n_real=self.n_real,
            dims=self.dims,
        )
        return basis, stats

    def _loss(self, params):
        _, stats = self._build_and_stats(params)
        return basis_nlml(stats, params["log_w"], params["log_noise"])

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False):
        x_new = jnp.asarray(x_new, dtype=self.x.dtype)
        if x_new.ndim == 1:
            x_new = x_new[:, None]

        if not hasattr(self, "_predict_jit"):

            def _predict(params, x_new):
                basis, stats = self._build_and_stats(params)
                Lp, theta = basis_posterior(stats, params["log_w"], params["log_noise"])
                Phis = phi(basis, params["kernels"], self.xg, x_new, dims=self.dims)
                mean = Phis @ theta
                sigma2 = jnp.exp(params["log_noise"])
                A = jax.scipy.linalg.solve_triangular(Lp, Phis.T, lower=True)
                return mean, sigma2 * jnp.sum(A**2, axis=0), sigma2

            self._predict_jit = jax.jit(_predict)

        mean, var, sigma2 = self._predict_jit(self.params, x_new)
        if not compute_var:
            return np.asarray(mean)
        if include_noise:
            var = var + sigma2
        return np.asarray(mean), np.asarray(var)
