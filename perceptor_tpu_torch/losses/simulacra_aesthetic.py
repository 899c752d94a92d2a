"""Simulacra aesthetic loss (counterpart of
perceptor_tpu/losses/simulacra_aesthetic.py): the multiplier times the
mean of (rating - target)^2, 1e-5 for the ViT-L-14 towers, else 1e-3."""

from __future__ import annotations

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.simulacra_aesthetic import SimulacraAesthetic as Model


class SimulacraAesthetic(LossInterface):
    def __init__(self, model_name: str = "ViT-L-14", aesthetic_target: float = 10, **kwargs):
        """`kwargs` go to `models.SimulacraAesthetic`."""
        self.aesthetic_target = float(aesthetic_target)
        self.model = Model(model_name, **kwargs)
        self.multiplier = 1e-5 if model_name in ("ViT-L-14", "ViT-L-14-336") else 1e-3

    def forward(self, images) -> torch.Tensor:
        return self.multiplier * torch.square(self.model(images) - self.aesthetic_target).mean()
