"""Deformable convolution v1 with torchvision's `deform_conv2d` semantics
(counterpart of perceptor_tpu/ops/deform_conv.py).

The JAX module is an XLA composite, not a Pallas kernel; plain PyTorch
calls stand for it here, in the same per-tap formulation: for each of the
K*K taps, bilinearly sample the input at (out_pos * stride - padding + tap *
dilation + offset), the four corners gathered as rows of an (H*W, C) table
(`F.embedding`: contiguous reads of C values a pixel), then contract the
sampled stack against the tap's weight slice. A corner outside the input
contributes zero on its own, so border samples blend with zeros (not
grid_sample's border clamp). Everything runs in fp32 whatever `x.dtype`,
and the result is cast back at the end.

Offsets are laid out as torchvision's: (batch, 2 * offset_groups * Kh * Kw,
H_out, W_out), (dy, dx) interleaved per (group, tap); input channels split
evenly over the offset groups. autograd gives the gradients to the input
(the gathers' scatter-add), the offsets (through the bilinear weights), the
weight and the bias.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear_sample(table, rows, ys, xs, h: int, w: int) -> torch.Tensor:
    """Sample the fp32 table (B * G * H * W, C) of each (batch, group)'s
    image at float coordinates ys, xs (B, G, Ho, Wo) -> (B, G, Ho * Wo, C).
    `rows` (B, G, 1) is each image's first row in the table."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    out = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yi, xi = y0 + dy, x0 + dx
            valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().flatten(2) + rows
            contrib = F.embedding(index, table) * (wy * wx * valid).flatten(2)[..., None]
            out = contrib if out is None else out + contrib
    return out


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntOrPair = 1,
    padding: IntOrPair = 0,
    dilation: IntOrPair = 1,
) -> torch.Tensor:
    """Deformable conv: x (B, C, H, W), offsets (B, 2*G*Kh*Kw, Ho, Wo),
    weight (O, C, Kh, Kw) -> (B, O, Ho, Wo) in x's dtype.

    The offset-group count G is inferred from the offset channels; C must
    divide by G. Padding is virtual (a coordinate shift into the
    zero-outside sampler), so no padded copy is made."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    b, c, h, w = x.shape
    oc, ic, kh, kw = weight.shape
    if ic != c:
        raise ValueError(f"weight expects {ic} input channels, got {c}")
    n_off = offsets.shape[1]
    if n_off % (2 * kh * kw):
        raise ValueError(f"offset channels {n_off} not divisible by 2*Kh*Kw={2 * kh * kw}")
    groups = n_off // (2 * kh * kw)
    if c % groups:
        raise ValueError(f"{c} channels not divisible by {groups} offset groups")
    h_out = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    w_out = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    if tuple(offsets.shape[2:]) != (h_out, w_out):
        raise ValueError(
            f"offsets spatial shape {tuple(offsets.shape[2:])} != output ({h_out}, {w_out})")

    cg = c // groups
    # (B, G, Kh, Kw, 2, Ho, Wo): torchvision's channel order
    off = offsets.float().reshape(b, groups, kh, kw, 2, h_out, w_out)
    base_y = (torch.arange(h_out, device=x.device, dtype=torch.float32) * sh - ph)[:, None]
    base_x = (torch.arange(w_out, device=x.device, dtype=torch.float32) * sw - pw)[None, :]
    table = x.float().reshape(b, groups, cg, h * w).transpose(2, 3).reshape(-1, cg)
    rows = (torch.arange(b * groups, device=x.device) * (h * w)).reshape(b, groups, 1)
    wg = weight.float().reshape(oc, groups, cg, kh, kw)
    out = None
    for i in range(kh):
        for j in range(kw):
            ys = base_y + i * dh + off[:, :, i, j, 0]
            xs = base_x + j * dw + off[:, :, i, j, 1]
            sampled = _bilinear_sample(table, rows, ys, xs, h, w)  # (B, G, P, Cg)
            tap = torch.einsum("bgpc,ogc->bop", sampled, wg[:, :, :, i, j])
            out = tap if out is None else out + tap
    out = out.reshape(b, oc, h_out, w_out)
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(x.dtype)
