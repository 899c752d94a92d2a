"""Shape assertions (counterpart of perceptor_tpu/core/shapes.py): the same
checks, exception types and messages, over torch tensors. Shapes print as
tuples, as JAX's do."""

from __future__ import annotations

from typing import Sequence, Union

Dim = Union[int, str, None]


def assert_shape(x, shape: Sequence[Dim], name: str = "array") -> None:
    """Assert x's shape. `None`/str entries are wildcards/named dims.

    Named (str) dims must agree wherever repeated: assert_shape(x, ("N", 3, "H", "H")).
    """
    actual_shape = tuple(x.shape)
    if x.ndim != len(shape):
        raise ValueError(
            f"{name}: expected rank {len(shape)} {tuple(shape)}, got shape {actual_shape}"
        )
    named: dict = {}
    for i, (actual, expected) in enumerate(zip(actual_shape, shape)):
        if expected is None:
            continue
        if isinstance(expected, str):
            if expected in named and named[expected] != actual:
                raise ValueError(
                    f"{name}: dim {i} ({expected})={actual} conflicts with "
                    f"earlier {expected}={named[expected]}; full shape {actual_shape}"
                )
            named[expected] = actual
        elif actual != expected:
            raise ValueError(
                f"{name}: expected shape {tuple(shape)}, got {actual_shape} (dim {i})"
            )


def assert_dims(x, ndim: int, name: str = "array") -> None:
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
