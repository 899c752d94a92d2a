"""GroupNorm and fused GroupNorm + activation (counterpart of
perceptor_tpu/ops/groupnorm.py).

`group_norm` and `group_norm_silu` take JAX's arguments and layout
(`channel_axis`, default last) and return the input's dtype;
`group_norm_fp32` is the NCHW fp32 norm the port's models use.

`fused_group_norm_act` is a `torch.autograd.Function` that saves only
(x, scale, bias, mean, rstd) and recomputes the normalized activations in
the backward, with every statistic in fp32 — the same backward as the JAX
custom VJP `_fused_gn_act_bwd`. No kernel: plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def group_norm(
    x: torch.Tensor,
    num_groups: int = 32,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    channel_axis: int = -1,
) -> torch.Tensor:
    """GroupNorm over (..., C) or (N, C, ...) tensors, JAX's signature and
    arithmetic: statistics in fp32 per (batch, group) over all positions and
    the group's channels, the normalized values cast to `x`'s dtype, then
    the per-channel `scale` and `bias` applied in that dtype."""
    channel_axis = channel_axis % x.ndim
    c = x.shape[channel_axis]
    if c % num_groups:
        raise ValueError(f"{c} channels not divisible by {num_groups} groups")
    xt = x.movedim(channel_axis, -1)
    shape = xt.shape
    g32 = xt.reshape(shape[0], -1, num_groups, c // num_groups).float()
    mean = g32.mean(dim=(1, 3), keepdim=True)
    var = g32.var(dim=(1, 3), keepdim=True, unbiased=False)
    normed = ((g32 - mean) * torch.rsqrt(var + eps)).reshape(shape).to(x.dtype)
    if scale is not None:
        normed = normed * scale.to(x.dtype)
    if bias is not None:
        normed = normed + bias.to(x.dtype)
    return normed.movedim(-1, channel_axis)


def group_norm_silu(
    x: torch.Tensor,
    num_groups: int = 32,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    channel_axis: int = -1,
) -> torch.Tensor:
    """`group_norm` followed by SiLU (JAX `group_norm_silu`)."""
    h = group_norm(x, num_groups, scale, bias, eps, channel_axis)
    return h * torch.sigmoid(h)


def group_norm_fp32(x: torch.Tensor, weight, bias, num_groups: int, eps: float) -> torch.Tensor:
    """NCHW GroupNorm with fp32 statistics and fp32 output (flax
    `nn.GroupNorm(dtype=float32)`), the norm of `ops.layers.GroupNorm`."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)


def _group_sum(per_channel: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(N, C) per-channel partials -> (N, G)."""
    n, c = per_channel.shape
    return per_channel.reshape(n, num_groups, c // num_groups).sum(dim=-1)


def _per_channel(per_group: torch.Tensor, c: int) -> torch.Tensor:
    """(N, G) -> (N, C, 1, 1), each group's value repeated over its channels."""
    n, g = per_group.shape
    return per_group.repeat_interleave(c // g, dim=1).reshape(n, c, 1, 1)


def _gn_stats(x: torch.Tensor, num_groups: int, eps: float):
    n, c, h, w = x.shape
    xf = x.float()
    m = (h * w) * (c // num_groups)
    mean = _group_sum(xf.sum(dim=(2, 3)), num_groups) / m
    var = _group_sum(torch.square(xf).sum(dim=(2, 3)), num_groups) / m - torch.square(mean)
    return mean, torch.rsqrt(var + eps)


def _affine_bc(v: torch.Tensor) -> torch.Tensor:
    """(C,) or (N, C) affine -> broadcastable (1|N, C, 1, 1) fp32."""
    v = v.float()
    if v.ndim == 1:
        return v[None, :, None, None]
    return v[:, :, None, None]


def _apply_act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return h * torch.sigmoid(h)
    if activation == "relu":
        return torch.clamp(h, min=0.0)
    if activation == "gelu":
        return F.gelu(h)
    if activation == "none":
        return h
    raise ValueError(f"unsupported activation {activation!r}")


def _act_grad(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        s = torch.sigmoid(h)
        return s * (1.0 + h * (1.0 - s))
    if activation == "relu":
        return (h > 0.0).to(h.dtype)
    if activation == "gelu":
        # d/dh [h * Phi(h)] = Phi(h) + h * phi(h)
        cdf = 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
        return cdf + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
    if activation == "none":
        return torch.ones_like(h)
    raise ValueError(f"unsupported activation {activation!r}")


class _FusedGroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, out_dtype, activation):
        mean, rstd = _gn_stats(x, num_groups, eps)
        c = x.shape[1]
        xhat = (x.float() - _per_channel(mean, c)) * _per_channel(rstd, c)
        h = xhat * _affine_bc(scale) + _affine_bc(bias)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.activation = activation
        return _apply_act(h, activation).to(out_dtype or x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        n, c, hh, ww = x.shape
        num_groups = mean.shape[1]
        m = hh * ww * (c // num_groups)

        rstd_c = _per_channel(rstd, c)
        xhat = (x.float() - _per_channel(mean, c)) * rstd_c
        h = xhat * _affine_bc(scale) + _affine_bc(bias)
        dh = dy.float() * _act_grad(h, ctx.activation)
        dxhat = dh * _affine_bc(scale)

        dh_nc = dh.sum(dim=(2, 3))  # (N, C)
        dhx_nc = (dh * xhat).sum(dim=(2, 3))  # (N, C)
        if scale.ndim == 1:
            dscale = dhx_nc.sum(dim=0).to(scale.dtype)
            dbias = dh_nc.sum(dim=0).to(bias.dtype)
        else:
            dscale = dhx_nc.to(scale.dtype)
            dbias = dh_nc.to(bias.dtype)

        scale_f = scale.float()
        scale_f = scale_f[None] if scale_f.ndim == 1 else scale_f
        a_c = _per_channel(_group_sum(dh_nc * scale_f, num_groups) / m, c)
        b_c = _per_channel(_group_sum(dhx_nc * scale_f, num_groups) / m, c)
        dx = (rstd_c * (dxhat - a_c - xhat * b_c)).to(x.dtype)
        return dx, dscale, dbias, None, None, None, None


def fused_group_norm_act(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    out_dtype: Optional[torch.dtype] = None,
    activation: str = "silu",
) -> torch.Tensor:
    """act(group_norm(x) * scale + bias) over NCHW, fp32 statistics.

    `scale`/`bias` are per-channel (C,) or per-sample (N, C); `activation`
    is "silu" | "relu" | "gelu" (exact) | "none". Output in `out_dtype`
    (default: x.dtype).
    """
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels not divisible by {num_groups} groups")
    return _FusedGroupNormAct.apply(x, scale, bias, num_groups, eps, out_dtype, activation)


class GroupNormSiLU(nn.Module):
    """GroupNorm(min(32, C) groups) + SiLU with the fused backward; param
    names (weight, bias) follow torch.nn.GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps)


class ScaleShiftGroupNormSiLU(nn.Module):
    """silu(group_norm(x) * (1 + scale) + shift) with scale/shift (N, C) from
    a conditioning embedding: ADM's `use_scale_shift_norm`, as one fused op.
    The learned GroupNorm affine and the embedding's fold into one (N, C)
    pair; param names (weight, bias) follow torch.nn.GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-5, num_groups: int = 32,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, scale_nc: torch.Tensor, shift_nc: torch.Tensor):
        one_plus = 1.0 + scale_nc.float()
        a = self.weight.float()[None] * one_plus
        b = self.bias.float()[None] * one_plus + shift_nc.float()
        return fused_group_norm_act(x, a, b, self.num_groups, self.eps, self.out_dtype)
