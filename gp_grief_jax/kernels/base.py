"""Kernel base machinery: hyperparameter pytrees with positivity transforms.

JAX replacement for the reference's ``BaseKernel`` parameter plumbing
(reference: ``gp_grief/kern.py``, class ``BaseKernel`` — SURVEY.md §2 #10).
The reference stores named parameters with positivity constraints via a log
transform and packs them to a flat vector for SciPy; here a kernel *is* a
frozen dataclass pytree whose leaves are the unconstrained (log-space) raw
parameters, so ``jax.grad``/``optax`` traverse it directly — no pack/unpack
layer, no finite differences (BASELINE.json north star).

Fixing/freeing parameters (the reference's ``fix``/``free``) is expressed with
``stop_gradient`` masks at the model layer rather than by removing leaves, so
pytree structure (and therefore jit caches) never changes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def positive(raw: jax.Array) -> jax.Array:
    """Unconstrained → positive: ``exp`` (matches the reference's log transform)."""
    return jnp.exp(raw)


def inverse_positive(value) -> jax.Array:
    """Positive → unconstrained."""
    return jnp.log(jnp.asarray(value, dtype=jnp.result_type(float)))


def param_dataclass(cls):
    """Register a frozen dataclass as a JAX pytree (all fields are leaves
    unless annotated in ``cls.__static_fields__``)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    static = getattr(cls, "__static_fields__", ())
    data_fields = [f.name for f in dataclasses.fields(cls) if f.name not in static]
    meta_fields = [f.name for f in dataclasses.fields(cls) if f.name in static]
    return jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
