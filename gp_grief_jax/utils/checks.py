"""Runtime numeric guards (`checkify`) — the failure-detection story.

The reference's only failure handling is SciPy CG's convergence flag and
retrying Cholesky with jitter (SURVEY.md §5).  Here: functional error checks
that survive jit — wrap an NLML or solver step with :func:`guarded` and every
non-finite intermediate raises a checkify error with a named site instead of
silently poisoning downstream math.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["check_finite", "guarded"]


def check_finite(x: jax.Array, name: str = "value") -> None:
    """Inside a ``checkify``-wrapped function: error if ``x`` has NaN/Inf."""
    checkify.check(jnp.all(jnp.isfinite(x)), f"non-finite values in {name}")


def guarded(fn: Callable, *, check_output: bool = True) -> Callable:
    """Wrap ``fn`` with checkify; returns ``wrapped(*args) -> value`` that
    raises ``checkify.JaxRuntimeError`` on any triggered check (including the
    output-finiteness check added here).  jit-compatible.
    """

    def _with_output_check(*args, **kwargs):
        out = fn(*args, **kwargs)
        if check_output:
            for leaf in jax.tree_util.tree_leaves(out):
                if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
                    check_finite(leaf, "output")
        return out

    checked = checkify.checkify(_with_output_check)

    def wrapped(*args, **kwargs):
        err, out = checked(*args, **kwargs)
        err.throw()
        return out

    return wrapped

