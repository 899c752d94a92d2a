"""Memorability loss (counterpart of perceptor_tpu/losses/memorability.py).

torchvision's `Resize(256)` (the short side to 256, the aspect kept) and
`CenterCrop(227)`, made differentiable through `ops/resize.resize`, then
the frozen ResMem scorer (`models/resmem.py`); the loss is
`prediction.mean() * 0.05`, so raising memorability takes a negative
weight, as in the reference.
"""

from __future__ import annotations

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.resmem import ResMem
from perceptor_tpu_torch.ops.resize import resize


def _recenter(images, short_side: int, crop: int):
    """Differentiable Resize(short_side) + CenterCrop(crop), NCHW."""
    h, w = images.shape[-2:]
    scale = short_side / min(h, w)
    out_h, out_w = max(round(h * scale), crop), max(round(w * scale), crop)
    images = resize(images, out_shape=(out_h, out_w))
    top = (out_h - crop) // 2
    left = (out_w - crop) // 2
    return images[..., top : top + crop, left : left + crop]


class Memorability(LossInterface):
    def __init__(self, name: str = "resmem", **kwargs):
        """`kwargs` are `device` and `seed` of `models.ResMem`."""
        self.model = ResMem(name, **kwargs)
        # Resize(256) + CenterCrop(227); the tiny variant scales both down
        self.short_side = 256 if name == "resmem" else self.model.crop_size + 5

    def forward(self, images) -> torch.Tensor:
        recentered = _recenter(images, self.short_side, self.model.crop_size)
        return torch.mean(self.model.predict(recentered)) * 0.05
