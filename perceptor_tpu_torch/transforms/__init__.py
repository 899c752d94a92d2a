"""Differentiable image transforms (counterpart of
perceptor_tpu/transforms/__init__.py)."""

from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.transforms.clamp import ClampWithGrad
from perceptor_tpu_torch.transforms.cutouts import (
    RandomCutouts,
    crop_and_resize,
    random_cutout_boxes,
    random_cutouts,
)
from perceptor_tpu_torch.transforms.dynamic_threshold import DynamicThreshold, dynamic_threshold
from perceptor_tpu_torch.transforms.interface import TransformInterface
from perceptor_tpu_torch.transforms.resize_transform import Resize
from perceptor_tpu_torch.transforms.super_resolution import SuperResolution

__all__ = [
    "TransformInterface",
    "clamp_with_grad",
    "ClampWithGrad",
    "resize",
    "Resize",
    "crop_and_resize",
    "random_cutout_boxes",
    "random_cutouts",
    "RandomCutouts",
    "dynamic_threshold",
    "DynamicThreshold",
    "SuperResolution",
]
