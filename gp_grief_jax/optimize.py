"""Hyperparameter optimization: `jax.grad` NLML + optax L-BFGS / Adam.

Replaces the reference's ``BaseModel.optimize`` (reference:
``gp_grief/models.py`` — SURVEY.md §2 #15), which drives SciPy L-BFGS-B with
**finite-difference** gradients — (#params+1) NLML evaluations per step.  Here
the objective is a pure function of a parameter pytree, gradients are exact
reverse-mode, and each optimizer step is one jitted program (value+grad+update
fused); L-BFGS linesearch included via optax.

``checkgrad`` inverts the reference's arrangement (SURVEY.md §3.5): analytic
``jax.grad`` is primary and central finite differences are the *test*.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.flatten_util import ravel_pytree

__all__ = ["fit", "FitResult", "checkgrad"]


class FitResult(NamedTuple):
    params: Any
    losses: np.ndarray  # (iters,) NLML trace
    grad_norms: np.ndarray  # (iters,)
    iterations: int
    wall_time: float
    converged: bool
    # Final optimizer state: checkpoint it alongside params
    # (utils.checkpoint.save_pytree) and pass back via fit(opt_state=...) to
    # resume a long optimization exactly (SURVEY §5 checkpoint/resume).
    opt_state: Any = None


def fit(
    loss_fn: Callable[[Any], jax.Array],
    params: Any,
    *,
    optimizer: str = "lbfgs",
    max_iters: int = 100,
    tol: float = 1e-6,
    learning_rate: float = 0.05,
    verbose: bool = False,
    callback: Optional[Callable[[int, float, float], None]] = None,
    fixed: Any = None,
    opt_state: Any = None,
    scan_chunk: Optional[int] = None,
) -> FitResult:
    """Minimize ``loss_fn(params)`` over a parameter pytree.

    ``optimizer``: ``"lbfgs"`` (default — the reference uses L-BFGS-B) or
    ``"adam"``.  Convergence: gradient ∞-norm below ``tol``.  The step is
    jitted once; the Python loop only carries host-side convergence checks and
    logging (the per-step NLML/grad-norm trace is the reference's
    ``messages=True`` equivalent, returned as data).

    ``fixed``: optional pytree matching ``params`` whose leaves are booleans
    (Python bools or boolean arrays broadcastable to the leaf) — the
    reference's per-parameter fix/free surface (SURVEY.md §2 #10/#15).  Fixed
    leaves/components get zero gradient (``stop_gradient``) so every optimizer
    leaves them untouched.

    ``opt_state``: resume from a previous :class:`FitResult`'s ``opt_state``
    (e.g. restored with :func:`gp_grief_jax.utils.checkpoint.load_pytree`) —
    with the same optimizer/params, ``fit(n) then fit(m, opt_state=...)``
    reproduces ``fit(n+m)`` exactly.

    ``scan_chunk``: optimizer steps per device program (host syncs only
    between chunks).  Default 25; where per-chunk dispatch dominates
    small-step objectives, larger chunks amortize it.  ``1``
    forces the per-step path (as do ``verbose``/``callback``).
    """
    if fixed is not None:
        base_loss = loss_fn
        fixed_tree = fixed

        def loss_fn(p):
            def mask_leaf(pi, fi):
                if isinstance(fi, bool) or (
                    isinstance(fi, np.bool_) and np.ndim(fi) == 0
                ):
                    return lax.stop_gradient(pi) if fi else pi
                return jnp.where(fi, lax.stop_gradient(pi), pi)

            return base_loss(jax.tree.map(mask_leaf, p, fixed_tree))

    if optimizer == "lbfgs":
        opt = optax.lbfgs()
    elif optimizer == "adam":
        opt = optax.adam(learning_rate)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    # Hoist arrays the objective closes over (training data, plans, cached
    # stats) into an explicit argument of every jitted step program instead
    # of baking them in as program constants (gp_grief_jax.utils.closure).
    from gp_grief_jax.utils.closure import explicit_closure

    _sds = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)), params
    )
    loss_pure, loss_consts = explicit_closure(loss_fn, _sds)

    def _one_step(params, opt_state, consts):
        lf = lambda p: loss_pure(consts, p)  # noqa: E731 — consts is a tracer here
        value, grad = jax.value_and_grad(lf)(params)
        if optimizer == "lbfgs":
            updates, opt_state = opt.update(
                grad, opt_state, params, value=value, grad=grad, value_fn=lf
            )
        else:
            updates, opt_state = opt.update(grad, opt_state, params)
        params = optax.apply_updates(params, updates)
        gnorm = optax.global_norm(grad)
        return params, opt_state, value, gnorm

    step = jax.jit(_one_step)

    # Chunked scan: run `scan_chunk` steps per device program, syncing to host
    # only between chunks (per-step host syncs dominate small-p NLML steps).  Per-step paths keep the user callback semantics.
    if verbose or callback is not None:
        scan_chunk = 0
    elif scan_chunk is None:
        scan_chunk = max(1, min(25, max_iters))
    else:
        scan_chunk = max(1, min(int(scan_chunk), max_iters))

    @partial(jax.jit, static_argnames=("n",))
    def steps_scanned(params, opt_state, consts, n):
        def body(carry, _):
            p, s = carry
            p, s, value, gnorm = _one_step(p, s, consts)
            return (p, s), (value, gnorm)

        (params, opt_state), (values, gnorms) = lax.scan(
            body, (params, opt_state), None, length=n
        )
        return params, opt_state, values, gnorms

    if opt_state is None:
        opt_state = opt.init(params)
    losses, gnorms = [], []
    t0 = time.perf_counter()
    converged = False
    it = 0
    while it < max_iters and not converged:
        if scan_chunk > 1:
            n = min(scan_chunk, max_iters - it)
            new_params, new_state, vals, gns = steps_scanned(params, opt_state, loss_consts, n)
            vals, gns = np.asarray(vals), np.asarray(gns)
            bad = ~np.isfinite(vals)
            n_ok = int(np.argmax(bad)) if bad.any() else n
            if n_ok == n:
                params, opt_state = new_params, new_state
            elif n_ok > 0:
                # Re-run the finite prefix stepwise to recover its state.
                for _ in range(n_ok):
                    params, opt_state, _, _ = step(params, opt_state, loss_consts)
            it += n_ok
            losses.extend(vals[:n_ok].tolist())
            gnorms.extend(gns[:n_ok].tolist())
            if n_ok < n:
                break
            if gnorms and gnorms[-1] < tol:
                converged = True
            continue
        it += 1
        new_params, new_state, value, gnorm = step(params, opt_state, loss_consts)
        value_f, gnorm_f = float(value), float(gnorm)
        if not np.isfinite(value_f):
            # Reject the step that evaluated at a bad point: keep last params
            # AND last optimizer state (the rejected step's moments carry the
            # non-finite gradient — resuming from them would poison every
            # later update).
            break
        params, opt_state = new_params, new_state
        losses.append(value_f)
        gnorms.append(gnorm_f)
        if verbose:
            print(f"[fit:{optimizer}] iter {it:4d}  loss {value_f:.6f}  |g| {gnorm_f:.3e}")
        if callback is not None:
            callback(it, value_f, gnorm_f)
        if gnorm_f < tol:
            converged = True
    return FitResult(
        params=params,
        losses=np.asarray(losses),
        grad_norms=np.asarray(gnorms),
        iterations=it,
        opt_state=opt_state,
        wall_time=time.perf_counter() - t0,
        converged=converged,
    )


def _checkgrad_indices(params: Any, size: int, sample: Optional[int], seed: int):
    """Flat indices to FD-probe: all of them, or (small leaves ∪ a seeded
    random subset of large-leaf components) when ``sample`` caps the count."""
    if sample is None or sample >= size:
        return range(size)
    small, large = [], []
    off = 0
    for leaf in jax.tree_util.tree_leaves(params):
        ln = int(np.size(leaf))
        (small if ln <= 4 else large).extend(range(off, off + ln))
        off += ln
    take = max(0, min(sample - len(small), len(large)))
    rng = np.random.default_rng(seed)
    picked = rng.choice(len(large), size=take, replace=False) if take else []
    return sorted(set(small) | {large[int(j)] for j in picked})


def checkgrad(
    loss_fn: Callable[[Any], jax.Array],
    params: Any,
    *,
    eps: float = 1e-6,
    rtol: float = 1e-4,
    verbose: bool = False,
    sample: Optional[int] = None,
    sample_seed: int = 0,
):
    """Compare ``jax.grad`` against central finite differences per parameter.

    Returns ``(ok, table)`` where ``table`` rows are
    ``(index, analytic, numerical, relative_error)`` over the flattened
    parameter vector — the reference's ``checkgrad`` table (SURVEY.md §3.5)
    with the roles of analytic/numerical swapped.

    ``sample``: cap the number of finite-difference probes.  The full check
    is 4 NLML evaluations per flattened component — O(1,600) jitted
    programs at a p=400 weight vector, unusable beyond toy models (round-3
    review, weak #3).  With ``sample=k``, every component of SMALL pytree
    leaves (size ≤ 4 — the scalar hypers: noise, lengthscales) is always
    checked, plus a seeded random subset of the large leaves' components,
    total ≤ ``max(k, #small)``.  ``None`` checks everything.

    The numerical side is a Richardson-extrapolated central difference
    ``(4·fd(h) − fd(2h))/3`` — O(h⁴) truncation, so near-optimum points with
    huge third derivatives (``log w`` components driven toward −∞) don't
    produce spurious mismatches — combined with a *per-parameter* round-off
    floor ``~ε_f·|f|/h_i`` (scaled by the step actually taken for THAT
    component, so a large objective value cannot hide an O(1e-2)
    per-parameter gradient bug behind a global floor).
    """
    flat, unravel = ravel_pytree(params)
    flat = np.asarray(flat, dtype=np.float64)

    def f(vec):
        return float(loss_fn(unravel(jnp.asarray(vec, dtype=flat.dtype))))

    analytic = np.asarray(ravel_pytree(jax.grad(loss_fn)(params))[0], dtype=np.float64)
    f0 = abs(float(loss_fn(params)))
    eps_f = float(np.finfo(np.asarray(ravel_pytree(params)[0]).dtype).eps)
    # Large-objective step scaling (optimal-central-FD rule h* ~ (ε·|f|)^⅓):
    # at |f|~1e6 a 1e-6 step's round-off ε·|f|/h ≈ 1e-2 — exactly the size of
    # bug we must detect.  Growing the step
    # with ∛f0 drops round-off ~1e4× while Richardson keeps truncation O(h⁴)
    # negligible.
    step_scale = min(max(1.0, f0 ** (1.0 / 3.0)), 1e4)
    indices = _checkgrad_indices(params, flat.size, sample, sample_seed)
    rows = []
    ok = True
    for i in indices:
        e = np.zeros_like(flat)
        h = eps * step_scale * max(1.0, abs(flat[i]))
        e[i] = h
        fd_h = (f(flat + e) - f(flat - e)) / (2 * h)
        fd_2h = (f(flat + 2 * e) - f(flat - 2 * e)) / (4 * h)
        num = (4.0 * fd_h - fd_2h) / 3.0  # Richardson: truncation O(h⁴)
        denom = max(abs(analytic[i]), abs(num), 1e-12)
        rel = abs(analytic[i] - num) / denom
        # Round-off of the extrapolated quotient: ~ε_eval·|f|/h per step,
        # where ε_eval models the jitted NLML's *evaluation* noise — long
        # reductions and factorizations carry ~30–60× machine epsilon
        # (measured on the 1k-point f64 drive: FD scatter ≈ 6e-12 absolute at
        # |f|≈850, i.e. ε_eval ≈ 7e-15 ≈ 32·ε_mach).  The floor still scales
        # with the step taken for THIS component, so it stays per-parameter.
        noise_floor_i = 8.0 * 64.0 * eps_f * (1.0 + f0) / h
        bad = rel > rtol and abs(analytic[i] - num) > noise_floor_i
        rows.append((i, analytic[i], num, rel))
        if bad:
            ok = False
        if verbose:
            flag = "  <-- MISMATCH" if bad else ""
            print(f"  param[{i:3d}]  analytic {analytic[i]:+.6e}  fd {num:+.6e}  rel {rel:.2e}{flag}")
    return ok, rows
