"""Immutable pytree value objects (counterpart of
perceptor_tpu/core/pytree.py).

A `Functional` subclass is a frozen dataclass with `.replace()`, registered
with `torch.utils._pytree`: its fields are the children and its static
fields the node's context, so `tree_map`, `tree_flatten` and `torch.export`
see what `jax.tree_util` sees of the JAX class.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import torch.utils._pytree as pytree

T = TypeVar("T", bound="Functional")


def field(**kwargs) -> Any:
    """A child field (a leaf or subtree of the pytree)."""
    return dataclasses.field(**kwargs)


def static_field(**kwargs) -> Any:
    """A static field: part of the pytree's structure (its context), which
    may hold non-tensor Python values (callables, strings, shapes)."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


class _FunctionalMeta(type):
    def __new__(mcs, name, bases, namespace, **kwargs):
        cls = super().__new__(mcs, name, bases, namespace, **kwargs)
        if name == "Functional" and not bases:
            return cls
        cls = dataclasses.dataclass(frozen=True)(cls)
        data_names, static_names = [], []
        for f in dataclasses.fields(cls):
            (static_names if f.metadata.get("static", False) else data_names).append(f.name)

        def flatten(obj):
            children = [getattr(obj, n) for n in data_names]
            return children, tuple(getattr(obj, n) for n in static_names)

        def flatten_with_keys(obj):
            children, context = flatten(obj)
            return [(pytree.GetAttrKey(n), c) for n, c in zip(data_names, children)], context

        def unflatten(children, context):
            kw = dict(zip(data_names, children))
            kw.update(zip(static_names, context))
            return cls(**kw)

        pytree.register_pytree_node(
            cls, flatten, unflatten,
            serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
            flatten_with_keys_fn=flatten_with_keys,
        )
        return cls


class Functional(metaclass=_FunctionalMeta):
    """Base class for immutable pytree value objects: subclass, declare
    typed fields, get a frozen dataclass registered as a pytree, with
    `.replace()`."""

    def replace(self: T, **changes) -> T:
        return dataclasses.replace(self, **changes)
