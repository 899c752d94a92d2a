"""Total-variation-squared smoothness loss (counterpart of
perceptor_tpu/losses/smoothness.py)."""

from __future__ import annotations

import torch

from perceptor_tpu_torch.losses.interface import LossInterface


class Smoothness(LossInterface):
    def forward(self, images):
        gradient_height = images[:, :, 1:, :] - images[:, :, :-1, :]
        gradient_width = images[:, :, :, 1:] - images[:, :, :, :-1]
        return torch.mean(torch.square(gradient_height)) + torch.mean(
            torch.square(gradient_width)
        )
