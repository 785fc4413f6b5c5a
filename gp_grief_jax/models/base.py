"""Model base: parameter-pytree plumbing shared by all models.

Replaces the reference's ``BaseModel`` (reference: ``gp_grief/models.py`` —
SURVEY.md §2 #15).  The reference packs named parameters into a flat
log-transformed vector for SciPy and caches on parameter change; here the
parameters simply *are* a pytree and the NLML is a pure jitted function of it,
so there is nothing to pack and nothing to invalidate — XLA's compilation
cache plays the role of the reference's caching layer.

Also hosts the shared weighted-basis NLML/posterior math used by both
``GPGriefModel`` and ``GPweb`` (matrix inversion + determinant lemmas —
SURVEY.md §2 #17): with ``Φ (n×p)``, ``W = diag(w)``, ``K̃ = Φ W Φᵀ + σ² I``:

    P            = ΦᵀΦ + σ² W⁻¹                                (p×p)
    yᵀ K̃⁻¹ y     = (yᵀy − vᵀ P⁻¹ v) / σ²,        v = Φᵀ y
    log|K̃|       = log|P| + Σ log w + (n−p) log σ²
    θ | y        ~ N(P⁻¹ v, σ² P⁻¹)              (weight-space posterior)

so each NLML evaluation is O(p³) after O(n·p²) one-time reductions.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from gp_grief_jax.optimize import FitResult, checkgrad, fit
from gp_grief_jax.ops.solve import logdet_from_chol, solve_chol

__all__ = [
    "BaseModel", "BasisStats", "GRAM_PRECISION", "basis_nlml", "basis_posterior",
    "check_xy", "gram",
]

GRAM_PRECISION = jax.lax.Precision.HIGHEST
"""Precision of the ``ΦᵀΦ`` / ``Φᵀy`` reductions (GRIEF, sharded GRIEF,
GPweb).  HIGHEST (exact f32): measured on an H100 80GB HBM3 at a 400 W power
limit at the kin40k shape (n=30k, d=8, p=400, one ``opt_kernel_params``
value_and_grad step), DEFAULT (TF32) put the NLML 8.7e-3 relative from the
float64 value for a 4.33 ms step, HIGHEST 1.4e-4 for 5.14 ms — 60× the
accuracy for 19% more step time."""


def gram(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b`` at :data:`GRAM_PRECISION` (read at trace time)."""
    return jnp.matmul(a, b, precision=GRAM_PRECISION)


def check_xy(x, y, what: str = "x"):
    """Shape-validate a training pair: ``x (n, d)`` (1-D auto-promoted) against
    ``y`` with exactly ``n`` responses.  Raises ``ValueError`` (the reference's
    BaseModel did equivalent guards in ``__init__`` — SURVEY.md §2 #15); every
    model constructor funnels through this so a transposed/truncated ``y``
    fails loudly instead of broadcasting into a wrong-answer fit."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"{what} must be (n, d); got shape {x.shape}")
    if y.ndim != 1:
        y = y.reshape(-1) if y.size == x.shape[0] else y
    if y.ndim != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            f"y must have one response per row of {what}: "
            f"{what} has {x.shape[0]} rows, y has shape {jnp.asarray(y).shape}"
        )
    return x, y


class BaseModel:
    """Stateful API wrapper (reference parity) around a pure NLML function.

    Subclasses set ``self.params`` (a pytree) and implement ``_loss(params)``
    returning the negative log marginal likelihood.
    """

    params: Any

    def _loss(self, params) -> jax.Array:
        raise NotImplementedError

    @property
    def parameters(self) -> "np.ndarray":
        """Flat (log-transformed) hyperparameter vector — the reference's
        ``BaseModel.parameters`` get/set API (SURVEY.md §2 #15).  The pytree
        remains the primary representation; this view exists for parity and
        for external optimizers."""
        import numpy as np
        from jax.flatten_util import ravel_pytree

        return np.asarray(ravel_pytree(self.params)[0])

    @parameters.setter
    def parameters(self, vec) -> None:
        import numpy as np
        from jax.flatten_util import ravel_pytree

        flat, unravel = ravel_pytree(self.params)
        vec = jnp.asarray(np.asarray(vec), dtype=flat.dtype)
        if vec.shape != flat.shape:
            raise ValueError(f"expected {flat.shape[0]} parameters, got {vec.shape}")
        self.params = unravel(vec)

    # -- per-parameter fix/free (reference BaseKernel/BaseModel constraint
    #    surface — SURVEY.md §2 #10/#15) ------------------------------------

    def _param_leaf_names(self):
        """Dotted name per parameter leaf, e.g. ``kernels.0.log_lengthscale``."""
        from jax.tree_util import tree_flatten_with_path

        paths, _ = tree_flatten_with_path(self.params)

        def render(path):
            parts = []
            for k in path:
                for attr in ("key", "idx", "name"):
                    if hasattr(k, attr):
                        parts.append(str(getattr(k, attr)))
                        break
                else:
                    parts.append(str(k))
            return ".".join(parts)

        return [render(p) for p, _ in paths]

    def fix(self, *patterns: str) -> None:
        """Fix parameters during ``optimize`` (zero gradient).

        A pattern matches a leaf if it equals the leaf's dotted name
        (``"kernels.0.log_lengthscale"``) or any dot-separated suffix segment
        run of it (``"log_lengthscale"`` fixes every dimension's lengthscale;
        ``"log_noise"`` fixes the noise).  Raises on patterns matching nothing.
        """
        names = self._param_leaf_names()
        for pat in patterns:
            if not any(n == pat or n.endswith("." + pat) for n in names):
                raise ValueError(f"fix: pattern {pat!r} matches no parameter in {names}")
        self._fixed_patterns = getattr(self, "_fixed_patterns", set()) | set(patterns)

    def free(self, *patterns: str) -> None:
        """Undo :meth:`fix` for the given patterns (all, if none given)."""
        cur = getattr(self, "_fixed_patterns", set())
        self._fixed_patterns = cur - set(patterns) if patterns else set()

    @property
    def fixed_parameters(self) -> list:
        """Dotted names of currently-fixed parameter leaves."""
        pats = getattr(self, "_fixed_patterns", set())
        return [
            n
            for n in self._param_leaf_names()
            if any(n == p or n.endswith("." + p) for p in pats)
        ]

    def _fixed_mask(self):
        """Pytree of Python bools aligned with ``self.params`` (None if empty)."""
        pats = getattr(self, "_fixed_patterns", set())
        if not pats:
            return None
        from jax.tree_util import tree_flatten_with_path, tree_unflatten

        names = self._param_leaf_names()
        _, treedef = jax.tree_util.tree_flatten(self.params)
        mask = [
            any(n == p or n.endswith("." + p) for p in pats) for n in names
        ]
        return tree_unflatten(treedef, mask)

    def log_likelihood(self) -> float:
        """Log marginal likelihood at the current parameters.

        The jitted objective hoists closure-captured arrays (training data,
        interpolation plans, cached stats) into explicit arguments instead of
        baking them into the program as constants
        (``gp_grief_jax.utils.closure``).  Models that rebuild caches
        invalidate by popping ``_loss_jit`` (e.g. GPGriefModel)."""
        if not hasattr(self, "_loss_jit"):
            from gp_grief_jax.utils.closure import explicit_closure

            sds = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
                self.params,
            )
            pure, consts = explicit_closure(self._loss, sds)
            self._loss_jit = (jax.jit(pure), consts)
        fn, consts = self._loss_jit
        return -float(fn(consts, self.params))

    def optimize(self, **kwargs) -> FitResult:
        """Maximize the log marginal likelihood (reference ``optimize``)."""
        kwargs.setdefault("fixed", self._fixed_mask())
        res = fit(self._loss, self.params, **kwargs)
        self.params = res.params
        return res

    def checkgrad(
        self,
        *,
        eps: float = 1e-6,
        rtol: float = 1e-4,
        verbose: bool = False,
        sample: int | None = None,
        sample_seed: int = 0,
    ) -> bool:
        """Validate ``jax.grad`` against central finite differences.

        ``sample=k`` caps the FD probes at ~k components (all scalar hypers
        always included) so the check stays seconds-fast on p≳100 models."""
        ok, _ = checkgrad(
            self._loss, self.params, eps=eps, rtol=rtol, verbose=verbose,
            sample=sample, sample_seed=sample_seed,
        )
        return ok


class BasisStats(NamedTuple):
    """Sufficient statistics of a fixed basis: one-time O(n·p²) reductions."""

    C: jax.Array  # (p, p) ΦᵀΦ
    v: jax.Array  # (p,)   Φᵀy
    yy: jax.Array  # ()     yᵀy
    n: int


def basis_stats_from_phi(Phi, y, *, chunk: int = 131072) -> BasisStats:
    """``BasisStats`` of a dense precomputed ``Φ``, row-chunked.

    One-shot ``Φᵀ Φ`` at n=2M/p=400 peaks several data-sized buffers in a
    single program; here a ``lax.scan`` over row blocks keeps the live set
    to one (chunk, p) block + the (p, p) accumulator."""
    n, p = Phi.shape
    if n <= chunk:
        return BasisStats(C=gram(Phi.T, Phi), v=gram(Phi.T, y), yy=jnp.dot(y, y), n=n)
    # Scan over dynamic_slice row windows of the UNPADDED Φ: a jnp.pad copy
    # doubles peak memory (two data-sized Φ buffers live) exactly where this
    # chunking exists to bound it.  Full blocks go through the scan; the
    # ragged remainder is one extra GEMM outside it.
    nfull = n // chunk
    rem = n - nfull * chunk
    # Carry dtype must match what the body accumulates (Φᵀy promotes to the
    # wider of Φ/y under x64) or lax.scan rejects the carry.
    dtype = jnp.result_type(Phi.dtype, y.dtype)

    def body(carry, k):
        C, v, yy = carry
        Pk = jax.lax.dynamic_slice(Phi, (k * chunk, 0), (chunk, p))
        yk = jax.lax.dynamic_slice(y, (k * chunk,), (chunk,))
        return (
            C + gram(Pk.T, Pk).astype(dtype),
            v + gram(Pk.T, yk).astype(dtype),
            yy + jnp.dot(yk, yk).astype(dtype),
        ), None

    (C, v, yy), _ = jax.lax.scan(
        body,
        (jnp.zeros((p, p), dtype), jnp.zeros((p,), dtype), jnp.zeros((), dtype)),
        jnp.arange(nfull),
    )
    if rem:
        Pr, yr = Phi[nfull * chunk :], y[nfull * chunk :]
        C = C + gram(Pr.T, Pr).astype(dtype)
        v = v + gram(Pr.T, yr).astype(dtype)
        yy = yy + jnp.dot(yr, yr).astype(dtype)
    return BasisStats(C=C, v=v, yy=yy, n=n)


def basis_nlml(stats: BasisStats, log_w: jax.Array, log_noise: jax.Array) -> jax.Array:
    """Negative log marginal likelihood of the weighted-basis GP, O(p³)."""
    p = stats.C.shape[0]
    sigma2 = jnp.exp(log_noise)
    P = stats.C + jnp.diag(sigma2 * jnp.exp(-log_w))
    L = jnp.linalg.cholesky(P)
    Linv_v = jax.scipy.linalg.solve_triangular(L, stats.v, lower=True)
    quad = (stats.yy - jnp.sum(Linv_v**2)) / sigma2
    logdet = (
        logdet_from_chol(L) + jnp.sum(log_w) + (stats.n - p) * log_noise
    )
    return 0.5 * (quad + logdet + stats.n * jnp.log(2.0 * jnp.pi))


def basis_posterior(stats: BasisStats, log_w: jax.Array, log_noise: jax.Array):
    """Weight-space posterior ``(L_P, θ_mean)`` with ``cov = σ² P⁻¹``."""
    sigma2 = jnp.exp(log_noise)
    P = stats.C + jnp.diag(sigma2 * jnp.exp(-log_w))
    L = jnp.linalg.cholesky(P)
    theta_mean = solve_chol(L, stats.v)
    return L, theta_mean
