"""filtered_lrelu: bias, FIR upsampling, leaky ReLU with gain and clamp, FIR
downsampling (counterpart of perceptor_tpu/ops/filtered_lrelu.py, itself the
reference implementation of StyleGAN3's op). The JAX module is an XLA
composite, not a Pallas kernel: two `upfirdn2d` calls (fp32 inside, the
input's dtype outside) and the elementwise middle stand for it here;
autograd gives the adjoint."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from perceptor_tpu_torch.ops.bias_act import bias_act
from perceptor_tpu_torch.ops.upfirdn import _pad_or_crop, upfirdn2d


def _parse_padding(padding) -> tuple:
    """int, (x, y) or (x0, x1, y0, y1), x the width."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    padding = tuple(int(p) for p in padding)
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    return padding


def filtered_lrelu(
    x: torch.Tensor,
    fu: Optional[torch.Tensor] = None,
    fd: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: Union[int, Sequence[int]] = 0,
    gain: float = math.sqrt(2),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H', W'): `x + b`, `upfirdn2d` up by `up` with
    gain up**2 and `padding` (negative crops; a plain pad without a filter),
    leaky ReLU of `slope` times `gain` clamped to `clamp`, `upfirdn2d` down
    by `down`."""
    px0, px1, py0, py1 = _parse_padding(padding)
    x = bias_act(x, b)
    if fu is not None or up > 1:
        f = fu if fu is not None else torch.ones((1, 1))
        x = upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up**2,
                      flip_filter=flip_filter)
    else:
        x = _pad_or_crop(x, px0, px1, py0, py1)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    if fd is not None or down > 1:
        f = fd if fd is not None else torch.ones((1, 1))
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
