"""A memo for functions that build tensors on a device.

`device_cache` is `functools.lru_cache` that steps aside while a
`FakeTensorMode` is active (`parallel.explain`, `torch.export`): there the
function runs uncached, so a fake tensor never enters the cache, where a
later real call would be handed it, and a real entry is never read into a
fake trace.
"""

from __future__ import annotations

import functools

import torch


def device_cache(maxsize: int = 128):
    """`functools.lru_cache(maxsize)`, bypassed under a fake-tensor mode;
    `cache_info` and `cache_clear` are the cache's."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch._guards.detect_fake_mode() is not None:
                return fn(*args, **kwargs)
            return cached(*args, **kwargs)

        call.cache_info = cached.cache_info
        call.cache_clear = cached.cache_clear
        return call

    return wrap
