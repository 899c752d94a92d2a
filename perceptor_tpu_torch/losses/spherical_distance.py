"""Pairwise image-image spherical distance for any encoder model
(counterpart of perceptor_tpu/losses/spherical_distance.py)."""

from __future__ import annotations

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.losses.prompt_bank import spherical_distance_squared


class SphericalDistance(LossInterface):
    def __init__(self, model):
        self.model = model

    def forward(self, images_a, images_b):
        return torch.mean(
            spherical_distance_squared(
                self.model.encode_images(images_a), self.model.encode_images(images_b)
            )
        )
