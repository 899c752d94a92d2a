"""MSE between two images after a resize to a common size (counterpart of
perceptor_tpu/losses/resize.py)."""

from __future__ import annotations

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.ops.resize import resize


class Resize(LossInterface):
    def __init__(self, size=None):
        self.size = size

    def forward(self, images_a, images_b, size=None):
        if size is None:
            size = self.size
        return torch.mean(
            torch.square(resize(images_a, out_shape=size) - resize(images_b, out_shape=size))
        )
