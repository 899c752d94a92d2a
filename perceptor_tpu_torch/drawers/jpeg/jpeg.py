"""JPEG drawer: an image parameterized by its quantized YCbCr DCT blocks
(counterpart of perceptor_tpu/drawers/jpeg/jpeg.py). The optimizable
parameters are the (y, cb, cr) coefficient tensors; `synthesize` is the
differentiable JPEG decode."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perceptor_tpu_torch.core.init import resolve_device
from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.drawers.jpeg.codec import JPEGCodec
from perceptor_tpu_torch.ops.resize import resize


class JPEG(DrawingInterface):
    def __init__(self, init_images, factor: float = 1.0, device="cuda"):
        """`init_images` (N, 3, H, W) in [0, 1], H and W multiples of 16;
        `device` is CUDA unless the caller passes "cpu"."""
        super().__init__()
        device = resolve_device(device)
        if not isinstance(init_images, torch.Tensor):
            init_images = torch.from_numpy(np.asarray(init_images, dtype=np.float32))
        init_images = init_images.detach().to(device=device, dtype=torch.float32)
        self.shape = tuple(init_images.shape)
        self.factor = factor
        self.codec = JPEGCodec().to(device)
        with torch.no_grad():
            self.coefficients = nn.ParameterList(
                nn.Parameter(blocks.clone()) for blocks in self.encode(init_images)
            )

    def synthesize(self, params=None):
        return self.decode(params if params is not None else tuple(self.coefficients))

    def encode(self, images):
        if tuple(images.shape[-2:]) != self.shape[-2:]:
            images = resize(images, out_shape=self.shape[-2:])
        return self.codec.compress(images, factor=self.factor)

    def decode(self, ycbcr):
        y, cb, cr = ycbcr
        return self.codec.decompress(y, cb, cr, self.shape[-2], self.shape[-1],
                                     factor=self.factor)
