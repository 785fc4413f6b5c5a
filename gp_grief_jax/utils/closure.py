"""Hoisting closure-captured arrays out of jitted programs.

``jax.jit`` of a function that closes over large concrete arrays (an
interpolation plan, a preconditioner factor) embeds them into the lowered
module as literal constants: a multi-GB captured preconditioner factor
makes the lowered module that large, and compile time and host memory grow
with it.
``jax.closure_convert`` does NOT help: it only hoists captured *tracers*,
concrete arrays stay baked in.

:func:`explicit_closure` traces the function once and returns a pure
equivalent whose captured arrays are an explicit leading argument, so jit
receives them as ordinary device buffers.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
from jax import tree_util

__all__ = ["explicit_closure"]


def explicit_closure(fn: Callable, *example_args) -> Tuple[Callable, list]:
    """Trace ``fn`` and hoist its closure-captured arrays into arguments.

    Returns ``(pure_fn, consts)`` with ``pure_fn(consts, *args)`` computing
    ``fn(*args)``; ``consts`` is the list of arrays ``fn`` closed over (the
    traced jaxpr's constants, unchanged device buffers — no copies).  Jitting
    ``pure_fn`` therefore embeds no data-sized literals.

    ``example_args`` may be arrays or ``jax.ShapeDtypeStruct`` pytrees (only
    shapes/dtypes are used; tracing never executes device code).
    """
    holder: dict[str, Any] = {}

    def wrapped(*args):
        out = fn(*args)
        flat, tree = tree_util.tree_flatten(out)
        holder["out_tree"] = tree
        return flat

    closed = jax.make_jaxpr(wrapped)(*example_args)
    out_tree = holder["out_tree"]
    consts = list(closed.consts)
    jaxpr = closed.jaxpr

    def pure_fn(consts_, *args):
        flat_args = tree_util.tree_leaves(args)
        out_flat = jax.core.eval_jaxpr(jaxpr, list(consts_), *flat_args)
        return tree_util.tree_unflatten(out_tree, out_flat)

    return pure_fn, consts
