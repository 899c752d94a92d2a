"""NCHW images in [0, 1] -> one PIL image, the batch stacked vertically
(counterpart of perceptor_tpu/utils/pil_image.py)."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def pil_image(images):
    """An (N, C, H, W) tensor or array in [0, 1] -> a PIL image of the
    batch stacked vertically, clipped to [0, 1] and rounded to 8 bits."""
    from PIL import Image

    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    images = np.asarray(images, dtype=np.float32)
    if images.ndim != 4:
        raise ValueError(f"expected NCHW, got shape {images.shape}")
    if images.max() > 1 or images.min() < 0:
        warnings.warn("images are not in range [0, 1]")
    n, c, h, w = images.shape
    stacked = np.clip(images.transpose(0, 2, 3, 1).reshape(n * h, w, c), 0.0, 1.0)
    array = (stacked * 255).round().astype(np.uint8)
    if c == 1:
        return Image.fromarray(array[..., 0], mode="L")
    return Image.fromarray(array)
