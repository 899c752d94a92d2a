"""Clamp transform (counterpart of perceptor_tpu/transforms/clamp.py)."""

from __future__ import annotations

from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.transforms.interface import TransformInterface


class ClampWithGrad(TransformInterface):
    def __init__(self, min_value=0.0, max_value=1.0):
        self.min_value = min_value
        self.max_value = max_value

    def encode(self, images):
        return clamp_with_grad(images, self.min_value, self.max_value)

    def decode(self, images):
        return images
