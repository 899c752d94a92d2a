"""upfirdn2d (upsample -> FIR filter -> downsample) and the fixed-blur FIR
resamplers (counterpart of perceptor_tpu/ops/upfirdn.py), NCHW.

The JAX module is an XLA composite, not a Pallas kernel; depthwise
`F.conv2d` / `F.conv_transpose2d` stand in for it here. Upsampling is zero
insertion (each sample followed by up - 1 zeros), negative padding crops,
downsampling is the convolution's stride, and `flip_filter=False` convolves
(correlation with the flipped taps), as StyleGAN's reference upfirdn2d.
autograd gives the adjoint.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

# k-diffusion's fixed resampling kernels
FIR_KERNELS = {
    "linear": [1 / 8, 3 / 8, 3 / 8, 1 / 8],
    "cubic": [
        -0.01171875, -0.03515625, 0.11328125, 0.43359375,
        0.43359375, 0.11328125, -0.03515625, -0.01171875,
    ],
    "lanczos3": [
        0.003689131001010537, 0.015056144446134567, -0.03399861603975296,
        -0.066637322306633, 0.13550527393817902, 0.44638532400131226,
        0.44638532400131226, 0.13550527393817902, -0.066637322306633,
        -0.03399861603975296, 0.015056144446134567, 0.003689131001010537,
    ],
}
FIR_KERNELS["bilinear"] = FIR_KERNELS["linear"]
FIR_KERNELS["bicubic"] = FIR_KERNELS["cubic"]

IntOrPair = Union[int, Sequence[int]]


def setup_filter(f, normalize: bool = True, gain: float = 1.0, separable=None) -> torch.Tensor:
    """Scalar, 1-D (made 2-D by the outer product) or 2-D taps -> an fp32
    2-D filter, normalized to unit sum, times `gain`. `separable` is taken
    and ignored, as in the JAX package: the filter is always 2-D."""
    f = np.asarray(f, dtype=np.float64)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    return torch.as_tensor((f * gain).astype(np.float32))


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _upsample_zeros(x: torch.Tensor, upy: int, upx: int) -> torch.Tensor:
    """Each sample followed by up - 1 zeros along H and W."""
    if upy == upx == 1:
        return x
    n, c, h, w = x.shape
    x = F.pad(x.reshape(n, c, h, 1, w, 1), [0, upx - 1, 0, 0, 0, upy - 1])
    return x.reshape(n, c, h * upy, w * upx)


def _pad_or_crop(x: torch.Tensor, px0: int, px1: int, py0: int, py1: int) -> torch.Tensor:
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    return x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0), max(-px0, 0):x.shape[3] - max(-px1, 0)]


def _depthwise(x: torch.Tensor, taps: torch.Tensor, stride) -> torch.Tensor:
    c = x.shape[1]
    return F.conv2d(x, taps[None, None].expand(c, 1, *taps.shape), stride=stride, groups=c)


def upfirdn2d(
    x: torch.Tensor,
    kernel,
    up: IntOrPair = 1,
    down: IntOrPair = 1,
    padding: Union[int, Sequence[int]] = 0,
    gain: float = 1.0,
    flip_filter: bool = False,
) -> torch.Tensor:
    """(N, C, H, W) -> upsample by `up` -> pad by `padding` (px0, px1, py0,
    py1; x is the width) -> FIR `kernel` -> downsample by `down`, in fp32,
    returned in x's dtype. `gain` is applied once, as given; a 1-D kernel
    filters H then W (its outer product, separably)."""
    upx, upy = _pair(up)
    downx, downy = _pair(down)
    px0, px1, py0, py1 = (padding,) * 4 if isinstance(padding, int) else padding
    taps = torch.as_tensor(kernel, dtype=torch.float32, device=x.device)
    if not flip_filter:
        taps = taps.flip(list(range(taps.ndim)))
    in_dtype = x.dtype
    y = _pad_or_crop(_upsample_zeros(x.float(), upy, upx), px0, px1, py0, py1)
    if taps.ndim == 1:
        y = _depthwise(y, (taps * gain)[:, None], (downy, 1))
        y = _depthwise(y, taps[None, :], (1, downx))
    else:
        y = _depthwise(y, taps * gain, (downy, downx))
    return y.to(in_dtype)


def _as_2d(kernel) -> torch.Tensor:
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    return torch.outer(kernel, kernel) if kernel.ndim == 1 else kernel


def filter2d(x, kernel, gain: float = 1.0, flip_filter: bool = False) -> torch.Tensor:
    """Same-size FIR filtering."""
    kernel = _as_2d(kernel)
    kh, kw = kernel.shape
    pad = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)
    return upfirdn2d(x, kernel, padding=pad, gain=gain, flip_filter=flip_filter)


def upsample2d(x, kernel, up: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR upsampling by `up` (gain up**2 keeps the mean)."""
    kernel = _as_2d(kernel)
    kh, kw = kernel.shape
    pad = ((kw + up - 1) // 2, (kw - up) // 2, (kh + up - 1) // 2, (kh - up) // 2)
    return upfirdn2d(x, kernel, up=up, padding=pad, gain=gain * up * up)


def downsample2d(x, kernel, down: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR downsampling by `down`."""
    kernel = _as_2d(kernel)
    kh, kw = kernel.shape
    pad = ((kw - down + 1) // 2, (kw - down) // 2, (kh - down + 1) // 2, (kh - down) // 2)
    return upfirdn2d(x, kernel, down=down, padding=pad, gain=gain)


def fir_taps(kernel: str = "linear", gain: float = 1.0, device=None) -> torch.Tensor:
    """The 2-D filter of a named k-diffusion kernel, times `gain`."""
    taps = torch.tensor(FIR_KERNELS[kernel], dtype=torch.float32, device=device) * gain
    return torch.outer(taps, taps)


def fir_downsample_2x(x: torch.Tensor, kernel: str = "linear",
                      pad_mode: str = "reflect") -> torch.Tensor:
    """k-diffusion's Downsample2d: pad by len / 2 - 1 (`pad_mode`), then a
    stride-2 depthwise blur, in fp32."""
    taps = fir_taps(kernel, device=x.device)
    pad = taps.shape[0] // 2 - 1
    y = F.pad(x.float(), (pad,) * 4, mode=pad_mode)
    return _depthwise(y, taps, 2).to(x.dtype)


def fir_upsample_2x(x: torch.Tensor, kernel: str = "linear",
                    pad_mode: str = "reflect") -> torch.Tensor:
    """k-diffusion's Upsample2d: pad by (len / 2 - 1 + 1) // 2 (`pad_mode`),
    then a stride-2 depthwise transposed convolution with the 1-D taps doubled
    (padding 2 pad + 1, which upfirdn2d's zero insertion and flipped taps
    reproduce), in fp32."""
    taps = fir_taps(kernel, gain=2.0, device=x.device)
    pad = taps.shape[0] // 2 - 1
    y = F.pad(x.float(), ((pad + 1) // 2,) * 4, mode=pad_mode)
    c = y.shape[1]
    weight = taps[None, None].expand(c, 1, *taps.shape)
    return F.conv_transpose2d(y, weight, stride=2, padding=pad * 2 + 1, groups=c).to(x.dtype)
