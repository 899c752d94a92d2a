"""Imagen-style dynamic thresholding (counterpart of
perceptor_tpu/transforms/dynamic_threshold.py).

Maps [0, 1] images to [-1, 1], clamps each batch item to its own `quantile`
percentile of |x| (floored at 1.0) with the gradient-preserving clamp,
divides by the threshold and maps back. The threshold carries no gradient
and is shaped (N, 1, 1, 1), one per item.

The threshold is `predictions.base.quantile_threshold`: jnp.quantile's
linear interpolation in fp32, on rows of any size.
"""

from __future__ import annotations

from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.predictions.base import quantile_threshold
from perceptor_tpu_torch.transforms.interface import TransformInterface


def dynamic_threshold(images, quantile=0.95):
    denoised_xs = images * 2.0 - 1.0
    threshold = quantile_threshold(denoised_xs.detach(), quantile, 1.0)
    denoised_xs = clamp_with_grad(denoised_xs, -threshold, threshold) / threshold
    return (denoised_xs + 1.0) / 2.0


class DynamicThreshold(TransformInterface):
    def __init__(self, quantile=0.95):
        self.quantile = quantile

    def encode(self, images, quantile=None):
        return dynamic_threshold(images, quantile or self.quantile)

    def decode(self, images):
        return images
