"""Differentiable image transforms (counterpart of
perceptor_tpu/transforms/__init__.py). `SuperResolution` is not ported yet
and raises an AttributeError that says so (ROADMAP.md queue A item 9)."""

from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.transforms.clamp import ClampWithGrad
from perceptor_tpu_torch.transforms.cutouts import (
    crop_and_resize,
    random_cutout_boxes,
    random_cutouts,
)
from perceptor_tpu_torch.transforms.dynamic_threshold import DynamicThreshold, dynamic_threshold
from perceptor_tpu_torch.transforms.interface import TransformInterface
from perceptor_tpu_torch.transforms.resize_transform import Resize

__all__ = [
    "TransformInterface",
    "clamp_with_grad",
    "ClampWithGrad",
    "resize",
    "Resize",
    "crop_and_resize",
    "random_cutout_boxes",
    "random_cutouts",
    "dynamic_threshold",
    "DynamicThreshold",
]


def __getattr__(name):
    if name == "SuperResolution":
        raise AttributeError(
            "perceptor_tpu_torch.transforms.SuperResolution is not ported yet "
            "(ROADMAP.md queue A item 9)"
        )
    raise AttributeError(f"module 'perceptor_tpu_torch.transforms' has no attribute {name!r}")
