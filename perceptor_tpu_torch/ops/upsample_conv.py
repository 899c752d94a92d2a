"""Nearest-neighbour 2x upsampling (counterpart of
perceptor_tpu/ops/upsample_conv.py `nearest_upsample_2x`), NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
