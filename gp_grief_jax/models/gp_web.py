"""GPweb: weighted-basis regression over a precomputed feature matrix.

Re-design of the reference's ``GPweb`` (reference: ``gp_grief/models.py`` —
SURVEY.md §2 #18, the paper's fast type-II reweighting experiments): given a
dense basis ``Φ`` from *any* source, train only the basis weights ``w`` and
noise ``σ²``.  Shares the O(p³) inversion/determinant-lemma core with
``GPGriefModel`` (``models/base.py``); the O(n·p²) reductions happen once at
construction, so ``n`` never appears in the training loop at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gp_grief_jax.kernels.base import inverse_positive
from gp_grief_jax.models.base import (
    BaseModel,
    basis_nlml,
    basis_posterior,
    basis_stats_from_phi,
    check_xy,
)

__all__ = ["GPweb"]


class GPweb(BaseModel):
    """Reference API: ``GPweb(Phi, y, noise_var)``.

    ``stats_chunk``: row-block size of the one-time O(n·p²) reductions —
    chunked so n=2M/p=400 never holds several data-sized buffers live in one
    program (round-3 weak #5)."""

    def __init__(self, Phi, y, noise_var: float = 1.0, *, stats_chunk: int = 131072):
        Phi, y = check_xy(Phi, y, what="Phi")
        n, p = Phi.shape
        self.stats = jax.jit(
            lambda Ph, yy: basis_stats_from_phi(Ph, yy, chunk=stats_chunk)
        )(Phi, y)
        self.p = p
        self.params = {
            "log_w": jnp.zeros((p,), dtype=Phi.dtype),
            "log_noise": inverse_positive(noise_var).astype(Phi.dtype),
        }

    def _loss(self, params):
        return basis_nlml(self.stats, params["log_w"], params["log_noise"])

    def predict(self, Phi_new, compute_var: bool = True, include_noise: bool = False):
        """Predict from features of the new points (``Φ*``)."""
        Phi_new = jnp.asarray(Phi_new)
        Lp, theta = basis_posterior(self.stats, self.params["log_w"], self.params["log_noise"])
        mean = Phi_new @ theta
        if not compute_var:
            return np.asarray(mean)
        sigma2 = jnp.exp(self.params["log_noise"])
        A = jax.scipy.linalg.solve_triangular(Lp, Phi_new.T, lower=True)
        var = sigma2 * jnp.sum(A**2, axis=0)
        if include_noise:
            var = var + sigma2
        return np.asarray(mean), np.asarray(var)
