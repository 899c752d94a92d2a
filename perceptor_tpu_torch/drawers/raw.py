"""Raw pixel-grid drawer (counterpart of perceptor_tpu/drawers/raw.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perceptor_tpu_torch.core.init import resolve_device
from perceptor_tpu_torch.drawers import inits
from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.ops.resize import resize


class Raw(DrawingInterface):
    def __init__(self, init_images, device="cuda"):
        """
        Minimal container for an optimizable pixel grid with init helpers,
        on `device` (CUDA unless the caller passes "cpu").

        Usage:

            drawer = Raw.random_fractal_image((1, 3, 256, 256), seed=0)
            images = drawer.synthesize()   # the pixel grid, an nn.Parameter
        """
        super().__init__()
        device = resolve_device(device)
        if not isinstance(init_images, torch.Tensor):
            init_images = torch.from_numpy(np.asarray(init_images, dtype=np.float32))
        self.pixels = nn.Parameter(
            init_images.detach().to(device=device, dtype=torch.float32).clone()
        )
        self.shape = tuple(self.pixels.shape)

    def synthesize(self, params=None):
        return params if params is not None else self.pixels

    def encode(self, images, mode="bilinear"):
        return resize(images, out_shape=self.shape[-2:], resample=mode)

    @staticmethod
    def random_fractal_image(shape, seed=None, device="cuda") -> "Raw":
        return Raw(inits.fractal(shape, seed), device=device)

    @staticmethod
    def random_gradient_image(shape, seed=None, device="cuda") -> "Raw":
        return Raw(inits.gradient(shape, seed), device=device)
