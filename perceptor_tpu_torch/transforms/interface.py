"""Invertible differentiable transform interface (counterpart of
perceptor_tpu/transforms/interface.py). Transforms are stateless callables
of their inputs."""

from __future__ import annotations


class TransformInterface:
    def __call__(self, *args, **kwargs):
        return self.encode(*args, **kwargs)

    def encode(self, *args, **kwargs):
        raise NotImplementedError

    def decode(self, *args, **kwargs):
        raise NotImplementedError
