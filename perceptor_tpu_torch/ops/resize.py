"""Differentiable antialiased resize, ResizeRight semantics, and plain
bilinear interpolation (counterpart of perceptor_tpu/ops/resize.py).

The dense per-dimension weight matrices are built on the host in numpy,
exactly as the JAX module builds them; the resize is two fp32 matmuls
whose adjoint autograd derives. fp32 matmuls must run in full fp32, not
TF32: `core.init.resolve_device`, which every entry point calls, sets
`torch.backends.cuda.matmul.allow_tf32 = False` explicitly (the JAX code
insists on `Precision.HIGHEST`). `interpolate_bilinear` keeps its device
matrices cached per (shape, align_corners, device).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from perceptor_tpu_torch.core.memo import device_cache

_EPS = float(np.finfo(np.float32).eps)


def _cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx**2
    absx3 = absx**3
    return (1.5 * absx3 - 2.5 * absx2 + 1.0) * (absx <= 1.0) + (
        -0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0
    ) * ((1.0 < absx) & (absx <= 2.0))


def _linear(x: np.ndarray) -> np.ndarray:
    return (x + 1) * ((-1 <= x) & (x < 0)) + (1 - x) * ((0 <= x) & (x <= 1))


def _lanczos2(x: np.ndarray) -> np.ndarray:
    return (
        (np.sin(np.pi * x) * np.sin(np.pi * x / 2) + _EPS)
        / ((np.pi**2 * x**2 / 2) + _EPS)
    ) * (np.abs(x) < 2)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    return (
        (np.sin(np.pi * x) * np.sin(np.pi * x / 3) + _EPS)
        / ((np.pi**2 * x**2 / 3) + _EPS)
    ) * (np.abs(x) < 3)


def _box(x: np.ndarray) -> np.ndarray:
    return ((-1 <= x) & (x < 0)).astype(np.float64) + ((0 <= x) & (x <= 1)).astype(
        np.float64
    )


_METHODS = {
    "cubic": (_cubic, 4.0),
    "bicubic": (_cubic, 4.0),
    "linear": (_linear, 2.0),
    "bilinear": (_linear, 2.0),
    "lanczos2": (_lanczos2, 4.0),
    "lanczos3": (_lanczos3, 6.0),
    "box": (_box, 1.0),
}


@functools.lru_cache(maxsize=512)
def _weight_matrix(
    in_size: int,
    out_size: int,
    scale: float,
    method: str,
    antialiasing: bool,
    pad_mode: str,
) -> np.ndarray:
    """Dense (out_size, in_size) resize matrix with ResizeRight semantics."""
    kernel_fn, support = _METHODS[method]

    if antialiasing and scale < 1.0:
        cur_kernel = lambda d: scale * kernel_fn(scale * d)  # noqa: E731
        cur_support = support / scale
    else:
        cur_kernel = kernel_fn
        cur_support = support

    # projected grid: output pixel centers mapped into input coordinates
    out_coords = np.arange(out_size, dtype=np.float64)
    projected = out_coords / scale + (in_size - 1) / 2 - (out_size - 1) / (2 * scale)

    left = np.ceil(projected - cur_support / 2 - _EPS).astype(np.int64)
    taps = int(math.ceil(cur_support - _EPS))
    fov = left[:, None] + np.arange(taps)[None, :]  # (out, taps)

    # normalized over the full field of view BEFORE boundary handling
    weights = cur_kernel(projected[:, None] - fov)
    wsum = weights.sum(axis=1, keepdims=True)
    wsum[wsum == 0] = 1.0
    weights = weights / wsum

    matrix = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(taps):
        idx = fov[:, tap]
        w = weights[:, tap]
        if pad_mode in ("constant", "zeros"):
            valid = (idx >= 0) & (idx < in_size)
            np.add.at(matrix, (np.nonzero(valid)[0], idx[valid]), w[valid])
        elif pad_mode in ("replicate", "edge"):
            np.add.at(matrix, (np.arange(out_size), np.clip(idx, 0, in_size - 1)), w)
        elif pad_mode == "reflect":
            reflected = np.abs(idx)
            period = max(2 * (in_size - 1), 1)
            reflected = reflected % period
            reflected = np.where(reflected >= in_size, period - reflected, reflected)
            np.add.at(matrix, (np.arange(out_size), reflected), w)
        else:
            raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    return matrix.astype(np.float32)


def resize_matrices(
    in_shape: Tuple[int, int],
    out_shape: Tuple[int, int],
    scale_factors: Tuple[float, float],
    method: Optional[str] = None,
    antialiasing: bool = True,
    pad_mode: str = "constant",
) -> Tuple[np.ndarray, np.ndarray]:
    """The (Wh, Ww) weight matrices used by `resize`."""
    if method is None:
        # lanczos3 to downscale, bicubic to upscale
        if in_shape[0] >= out_shape[0] and in_shape[1] >= out_shape[1]:
            method = "lanczos3"
        else:
            method = "bicubic"
    wh = _weight_matrix(
        in_shape[0], out_shape[0], float(scale_factors[0]), method, antialiasing, pad_mode
    )
    ww = _weight_matrix(
        in_shape[1], out_shape[1], float(scale_factors[1]), method, antialiasing, pad_mode
    )
    return wh, ww


def resize(
    images: torch.Tensor,
    scale_factors: Union[None, float, Sequence[float]] = None,
    out_shape: Optional[Sequence[int]] = None,
    resample: Optional[str] = None,
    antialiasing: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Differentiable antialiased resize of the last two (spatial) dims."""
    in_h, in_w = images.shape[-2], images.shape[-1]
    if scale_factors is None and out_shape is None:
        raise ValueError("either scale_factors or out_shape should be provided")

    if out_shape is not None:
        out_shape = tuple(int(s) for s in out_shape[-2:])
        if scale_factors is None:
            scale_factors = (out_shape[0] / in_h, out_shape[1] / in_w)
    if not isinstance(scale_factors, (tuple, list)):
        scale_factors = (float(scale_factors), float(scale_factors))
    scale_factors = tuple(float(s) for s in scale_factors[-2:])
    if out_shape is None:
        out_shape = (
            int(math.ceil(scale_factors[0] * in_h)),
            int(math.ceil(scale_factors[1] * in_w)),
        )

    if out_shape == (in_h, in_w) and all(s == 1.0 for s in scale_factors):
        return images

    wh, ww = resize_matrices(
        (in_h, in_w), out_shape, scale_factors, resample, antialiasing, pad_mode
    )
    if not images.is_floating_point():
        images = images.float()
    wh = torch.as_tensor(wh, dtype=images.dtype, device=images.device)
    ww = torch.as_tensor(ww, dtype=images.dtype, device=images.device)

    out = images
    if out_shape[0] != in_h or scale_factors[0] != 1.0:
        out = torch.matmul(wh, out)  # (out_H, H) x (..., H, W)
    if out_shape[1] != in_w or scale_factors[1] != 1.0:
        out = torch.matmul(out, ww.T)  # (..., out_H, W) x (W, out_W)
    return out


@functools.lru_cache(maxsize=256)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Bilinear (out_size, in_size) weights on the align_corners=True grid
    (F.interpolate(..., align_corners=True))."""
    if out_size == 1 or in_size == 1:
        matrix = np.zeros((out_size, in_size), dtype=np.float32)
        matrix[:, 0] = 1.0
        return matrix
    positions = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    low = np.floor(positions).astype(np.int64)
    high = np.minimum(low + 1, in_size - 1)
    frac = positions - low
    matrix = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(matrix, (np.arange(out_size), low), 1.0 - frac)
    np.add.at(matrix, (np.arange(out_size), high), frac)
    return matrix.astype(np.float32)


def _half_pixel_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Bilinear (out_size, in_size) weights with half-pixel centers and edge
    clamping (F.interpolate(..., align_corners=False))."""
    positions = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
    positions = np.maximum(positions, 0.0)
    low = np.minimum(np.floor(positions).astype(np.int64), in_size - 1)
    high = np.minimum(low + 1, in_size - 1)
    frac = positions - low
    matrix = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(matrix, (np.arange(out_size), low), 1.0 - frac)
    np.add.at(matrix, (np.arange(out_size), high), frac)
    return matrix.astype(np.float32)


@device_cache(maxsize=256)
def _bilinear_matrices(
    in_shape: Tuple[int, int], out_shape: Tuple[int, int], align_corners: bool,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (Wh, Ww) fp32 matrices of `interpolate_bilinear`, copied to
    `device` once per key, so a repeated call makes no host copy."""
    make = _align_corners_matrix if align_corners else _half_pixel_matrix
    return (
        torch.as_tensor(make(in_shape[0], out_shape[0]), device=device),
        torch.as_tensor(make(in_shape[1], out_shape[1]), device=device),
    )


def interpolate_bilinear(images: torch.Tensor, out_shape, align_corners: bool = True):
    """Plain (not antialiased) bilinear resize of the trailing two dims,
    F.interpolate(mode="bilinear") for either `align_corners`, as two fp32
    matmuls (the JAX code's matrix form); returns `images`' dtype."""
    out_shape = tuple(int(s) for s in out_shape[-2:])
    wh, ww = _bilinear_matrices(
        tuple(images.shape[-2:]), out_shape, bool(align_corners), images.device
    )
    out = torch.matmul(wh, images.float())
    return torch.matmul(out, ww.T).to(images.dtype)
