"""Resize as an invertible transform (counterpart of
perceptor_tpu/transforms/resize_transform.py)."""

from __future__ import annotations

from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.transforms.interface import TransformInterface


class Resize(TransformInterface):
    def __init__(self, out_shape=None, scale_factors=None, resample=None):
        self.out_shape = out_shape
        self.scale_factors = scale_factors
        self.resample = resample

    def encode(self, images):
        return resize(
            images,
            scale_factors=self.scale_factors,
            out_shape=self.out_shape,
            resample=self.resample,
        )

    def decode(self, images, out_shape):
        return resize(images, out_shape=out_shape, resample=self.resample)
