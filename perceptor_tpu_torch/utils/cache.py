"""Weakref-keyed constructor memoization (a copy of
perceptor_tpu/utils/cache.py).

Constructing the same model wrapper twice with the same arguments returns
the same live instance, so several losses share one frozen encoder's
parameters: one copy of the weights in device memory. The key is the text
of the arguments, so `device=` and `seed=` are part of it: a tower built
for the CPU is never handed to a caller that asked for CUDA.
"""

from __future__ import annotations

import weakref
from functools import wraps
from typing import TypeVar

T = TypeVar("T")


def cache(model: T) -> T:
    cached: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
    strong: dict = {}

    @wraps(model)
    def wrapper(*args, **kwargs):
        key = str(args) + str(kwargs)
        if key in cached:
            return cached[key]
        instance = model(*args, **kwargs)
        try:
            cached[key] = instance
        except TypeError:
            # Values that can't be weakly referenced are kept strongly.
            strong[key] = instance
        return strong.get(key, instance)

    return wrapper
