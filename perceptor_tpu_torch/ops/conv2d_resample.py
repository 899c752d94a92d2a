"""conv2d with FIR up- and downsampling, StyleGAN's toolbox op (counterpart
of perceptor_tpu/ops/conv2d_resample.py): the reference's generic path,
``downsample(conv2d(upsample(pad(x), f), w), f)``, with the padding applied
once up front, relative to the upsampled image. The JAX module is an XLA
composite, not a Pallas kernel: `upfirdn2d` and `F.conv2d` stand for it.
The convolution runs in fp32 with TF32 off (`core/init.resolve_device`), as
JAX's `Precision.HIGHEST`."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from perceptor_tpu_torch.ops.filtered_lrelu import _parse_padding
from perceptor_tpu_torch.ops.upfirdn import upfirdn2d


def _filter_size(f) -> tuple:
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[1]), int(f.shape[0])  # (fw, fh)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: Union[int, Sequence[int]] = 0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
) -> torch.Tensor:
    """2-D convolution of x (N, C_in, H, W) with w (C_out, C_in // groups,
    kh, kw) between FIR upsampling by `up` and downsampling by `down` with
    the taps `f` (1-D separable or 2-D; None: the identity). `padding` (int,
    (x, y) or (x0, x1, y0, y1)) is relative to the upsampled image and may
    be negative; `flip_weight=False` convolves instead of correlating, and
    `flip_filter` does the same for the taps."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"need 4D x and w, got {tuple(x.shape)} {tuple(w.shape)}")
    if f is not None:
        f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    fw, fh = _filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    # center the taps on the up / downsampling grid
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    identity = torch.ones((1, 1), device=x.device)
    up_filter = f if (up > 1 and f is not None) else identity
    x = upfirdn2d(x, up_filter, up=up, padding=(px0, px1, py0, py1), gain=up * up,
                  flip_filter=flip_filter)
    wk = w.to(x.dtype)
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        wk = wk.flip([2, 3])
    x = F.conv2d(x, wk, groups=groups)
    if down > 1:
        x = upfirdn2d(x, identity if f is None else f, down=down, flip_filter=flip_filter)
    return x
