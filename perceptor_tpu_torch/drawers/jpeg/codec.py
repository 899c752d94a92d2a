"""Differentiable JPEG codec (counterpart of
perceptor_tpu/drawers/jpeg/codec.py).

RGB <-> YCbCr, 2x chroma subsampling, 8x8 block DCT/IDCT against
precomputed cosine tensors, quantization against the standard luma/chroma
tables with the pseudo-differentiable rounding round(x) + (x - round(x))^3,
whose gradient plain autograd derives. The constant tensors are built once
in numpy and held as buffers of `JPEGCodec`; `compress_jpeg` and
`decompress_jpeg` use one codec per device.
"""

from __future__ import annotations

import functools
import itertools
from typing import Tuple

import numpy as np
import torch
from torch import nn

Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
).T

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]],
    dtype=np.float32,
).T

_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5], [0.5, -0.418688, -0.081312]],
    dtype=np.float32,
).T
_YCBCR2RGB = np.array(
    [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]],
    dtype=np.float32,
).T


def _dct_tensor() -> Tuple[np.ndarray, np.ndarray]:
    tensor = np.zeros((8, 8, 8, 8), dtype=np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        tensor[x, y, u, v] = np.cos((2 * x + 1) * u * np.pi / 16) * np.cos(
            (2 * y + 1) * v * np.pi / 16
        )
    alpha = np.array([1.0 / np.sqrt(2)] + [1.0] * 7)
    return tensor, np.outer(alpha, alpha).astype(np.float32)


def _idct_tensor() -> np.ndarray:
    tensor = np.zeros((8, 8, 8, 8), dtype=np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        tensor[x, y, u, v] = np.cos((2 * u + 1) * x * np.pi / 16) * np.cos(
            (2 * v + 1) * y * np.pi / 16
        )
    return tensor


def diff_round(x):
    """round(x) + (x - round(x))^3."""
    rounded = torch.round(x)
    return rounded + (x - rounded) ** 3


def quality_to_factor(quality: float) -> float:
    if quality < 50:
        quality = 5000.0 / quality
    else:
        quality = 200.0 - quality * 2
    return quality / 100.0


def _block_split(channel):
    """(N, H, W) -> (N, H*W/64, 8, 8)."""
    n, h, w = channel.shape
    blocks = channel.reshape(n, h // 8, 8, w // 8, 8)
    return blocks.permute(0, 1, 3, 2, 4).reshape(n, -1, 8, 8)


def _block_merge(blocks, height, width):
    n = blocks.shape[0]
    image = blocks.reshape(n, height // 8, width // 8, 8, 8)
    return image.permute(0, 1, 3, 2, 4).reshape(n, height, width)


class JPEGCodec(nn.Module):
    """The codec's constants as (non-persistent) buffers, and the two maps."""

    def __init__(self):
        super().__init__()
        dct, alpha = _dct_tensor()
        constants = {
            "dct": dct, "alpha": alpha, "idct": _idct_tensor(), "y_table": Y_TABLE,
            "c_table": C_TABLE, "rgb2ycbcr": _RGB2YCBCR, "ycbcr2rgb": _YCBCR2RGB,
            "chroma_offset": np.array([0.0, 128.0, 128.0], dtype=np.float32),
        }
        for name, value in constants.items():
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(value)),
                                 persistent=False)

    def _dct(self, blocks):
        return self.alpha * 0.25 * torch.tensordot(blocks - 128.0, self.dct, dims=2)

    def _idct(self, blocks):
        return 0.25 * torch.tensordot(blocks * self.alpha, self.idct, dims=2) + 128.0

    def compress(self, images, factor: float = 1.0, rounding=diff_round):
        """(N, 3, H, W) in [0, 1] -> (y, cb, cr) quantized DCT blocks."""
        x = images.permute(0, 2, 3, 1) * 255.0
        ycbcr = x @ self.rgb2ycbcr + self.chroma_offset
        y = ycbcr[..., 0]
        # 2x2 mean chroma subsampling
        n, h, w, _ = ycbcr.shape
        chroma = ycbcr[..., 1:].reshape(n, h // 2, 2, w // 2, 2, 2).mean(dim=(2, 4))
        cb, cr = chroma[..., 0], chroma[..., 1]
        return tuple(
            rounding(self._dct(_block_split(channel)) / (table * factor))
            for channel, table in ((y, self.y_table), (cb, self.c_table), (cr, self.c_table))
        )

    def decompress(self, y, cb, cr, height: int, width: int, factor: float = 1.0):
        """(y, cb, cr) blocks -> (N, 3, H, W) in [0, 1]."""
        channels = []
        for blocks, table, (h, w) in (
            (y, self.y_table, (height, width)),
            (cb, self.c_table, (height // 2, width // 2)),
            (cr, self.c_table, (height // 2, width // 2)),
        ):
            channels.append(_block_merge(self._idct(blocks * (table * factor)), h, w))
        y_full, cb_small, cr_small = channels
        cb_full = cb_small.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        cr_full = cr_small.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        ycbcr = torch.stack([y_full, cb_full, cr_full], dim=-1)
        rgb = (ycbcr - self.chroma_offset) @ self.ycbcr2rgb
        rgb = torch.clamp(rgb, 0.0, 255.0) / 255.0
        return rgb.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _codec(device: torch.device) -> JPEGCodec:
    return JPEGCodec().to(device)


def compress_jpeg(images, factor: float = 1.0, rounding=diff_round):
    """(N, 3, H, W) in [0, 1] -> (y, cb, cr) quantized DCT blocks, on the
    images' device."""
    return _codec(images.device).compress(images, factor, rounding)


def decompress_jpeg(y, cb, cr, height: int, width: int, factor: float = 1.0):
    """(y, cb, cr) blocks -> (N, 3, H, W) in [0, 1]."""
    return _codec(y.device).decompress(y, cb, cr, height, width, factor)
