"""OpenAI ADM UNet (counterpart of
perceptor_tpu/models/guided_diffusion/unet.py `ADMUNet`), NCHW.

Module names follow OpenAI's `guided_diffusion` UNetModel state_dict
(`input_blocks.{i}.{j}`, `in_layers.0/2`, `emb_layers.1`, `out_layers.0/3`,
`skip_connection`, `qkv`, `proj_out`, `time_embed.0/2`, `out.0/2`), so the
JAX package's `guided_diffusion/convert.py from_torch` maps this module's
`state_dict()` to its flax tree and `convert.adm_state_dict_from_jax` is the
inverse. Every conv/linear computes in its weight's dtype (bf16 storage =
bf16 compute); GroupNorm statistics and the attention softmax run in fp32;
the sinusoidal embedding stays fp32; the UNet returns fp32.

ResBlocks resample inside the block on both paths (`up`/`down`). The qkv
channel order is ADM's legacy head-interleaved one,
[head0(q|k|v), head1(q|k|v), ...]: the projection runs over (N, S, C) tokens
and q, k, v are strided (N, H, S, d) views of its output, which the flash
kernels take as they are.

The latent diffusion family's `spatial_transformer` branch is not ported
yet (ROADMAP.md queue A item 5.3).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.stable_diffusion.unet import timestep_embedding
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.conv_matmul import Conv3x3
from perceptor_tpu_torch.ops.groupnorm import GroupNormSiLU, ScaleShiftGroupNormSiLU
from perceptor_tpu_torch.ops.layers import Conv2d, GroupNorm, Linear
from perceptor_tpu_torch.ops.upsample_conv import nearest_upsample_2x


def _groups(channels: int) -> int:
    """ADM's GroupNorm32; configs whose channel counts 32 does not divide
    (the tiny test ones) take the largest common divisor."""
    return math.gcd(32, channels)


class Conv1x1Tokens(nn.Module):
    """A kernel-size-1 `nn.Conv1d` (weight (O, I, 1), as ADM stores `qkv` and
    `proj_out`) applied to (N, S, I) tokens as a matmul in the weight's
    dtype."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.linear(tokens.to(w.dtype), w[:, :, 0], self.bias.to(w.dtype))


class ResBlock(nn.Module):
    """GN-SiLU-(resample)-conv, the timestep embedding as a scale-shift on
    the second norm (or added before it), GN-SiLU-conv, plus the (resampled,
    1x1-projected) input."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.ModuleList([
            GroupNormSiLU(in_channels, num_groups=_groups(in_channels)),
            nn.Identity(),
            Conv3x3(in_channels, out_channels),
        ])
        emb_width = out_channels * (2 if use_scale_shift_norm else 1)
        self.emb_layers = nn.ModuleList([nn.Identity(), Linear(time_dim, emb_width)])
        norm2 = ScaleShiftGroupNormSiLU if use_scale_shift_norm else GroupNormSiLU
        self.out_layers = nn.ModuleList([
            norm2(out_channels, num_groups=_groups(out_channels)),
            nn.Identity(),
            nn.Identity(),
            Conv3x3(out_channels, out_channels),
        ])
        self.skip_connection = (
            Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else nn.Identity()
        )

    def forward(self, x, emb):
        h = self.in_layers[0](x)
        if self.up:
            h, x = nearest_upsample_2x(h), nearest_upsample_2x(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb))
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_layers[0](h, scale, shift)
        else:
            h = self.out_layers[0](h + emb_out[:, :, None, None])
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """GN -> qkv -> multi-head self-attention over the HW tokens -> proj_out
    + residual. `use_flash` None routes by `ops.attention.flash_route`;
    True/False force a route."""

    def __init__(self, channels: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.norm = GroupNorm(channels, eps=1e-5, num_groups=_groups(channels))
        self.qkv = Conv1x1Tokens(channels, channels * 3)
        self.proj_out = Conv1x1Tokens(channels, channels)
        self.use_flash: Optional[bool] = None

    def forward(self, x):
        n, c, h, w = x.shape
        d = c // self.n_heads
        tokens = self.norm(x).reshape(n, c, h * w).transpose(1, 2)
        # (N, S, 3C) with channels [head0(q|k|v), head1(q|k|v), ...]
        qkv = self.qkv(tokens).view(n, h * w, self.n_heads, 3, d)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        y = attention(q, k, v, scale=1.0 / math.sqrt(d), use_flash=self.use_flash)
        y = self.proj_out(y.transpose(1, 2).reshape(n, h * w, c))
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class TimestepBlocks(nn.ModuleList):
    """ADM's TimestepEmbedSequential: ResBlocks take the embedding."""

    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class ADMUNet(nn.Module):
    """forward(xs NCHW in [-1, 1], timesteps (N,) or scalar) ->
    (N, out_channels, H, W), fp32."""

    def __init__(self, config: ADMConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.spatial_transformer:
            raise NotImplementedError(
                "the spatial_transformer ADM UNet belongs to the latent diffusion family, "
                "which is not ported yet (ROADMAP.md queue A item 5.3)"
            )
        time_dim = cfg.model_channels * 4
        self.time_embed = nn.ModuleList(
            [Linear(cfg.model_channels, time_dim), nn.Identity(), Linear(time_dim, time_dim)]
        )

        def res_block(ch_in, ch_out, **resample):
            return ResBlock(ch_in, ch_out, time_dim, cfg.use_scale_shift_norm, **resample)

        def attn_block(ch):
            return AttentionBlock(ch, cfg.heads_for(ch))

        ch = int(cfg.channel_mult[0] * cfg.model_channels)
        blocks = [TimestepBlocks([Conv3x3(cfg.in_channels, ch)])]
        skip_channels = [ch]
        ds = 1
        n_levels = len(cfg.channel_mult)
        for level, mult in enumerate(cfg.channel_mult):
            out_ch = int(mult * cfg.model_channels)
            for _ in range(cfg.num_res_blocks):
                layers = [res_block(ch, out_ch)]
                ch = out_ch
                if ds in cfg.attention_ds:
                    layers.append(attn_block(ch))
                blocks.append(TimestepBlocks(layers))
                skip_channels.append(ch)
            if level != n_levels - 1:
                down = res_block(ch, ch, down=True) if cfg.resblock_updown else Downsample(ch)
                blocks.append(TimestepBlocks([down]))
                skip_channels.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)

        self.middle_block = TimestepBlocks([res_block(ch, ch), attn_block(ch), res_block(ch, ch)])

        blocks = []
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            out_ch = int(mult * cfg.model_channels)
            for i in range(cfg.num_res_blocks + 1):
                layers = [res_block(ch + skip_channels.pop(), out_ch)]
                ch = out_ch
                if ds in cfg.attention_ds:
                    layers.append(attn_block(ch))
                if level and i == cfg.num_res_blocks:
                    up = res_block(ch, ch, up=True) if cfg.resblock_updown else Upsample(ch)
                    layers.append(up)
                    ds //= 2
                blocks.append(TimestepBlocks(layers))
        self.output_blocks = nn.ModuleList(blocks)

        self.out = nn.ModuleList([
            GroupNormSiLU(ch, num_groups=_groups(ch)), nn.Identity(), Conv3x3(ch, cfg.out_channels),
        ])

    def forward(self, xs, timesteps, context=None):
        if context is not None:
            raise ValueError("this ADM UNet takes no context (no spatial_transformer)")
        if not torch.is_tensor(timesteps):
            timesteps = torch.tensor(timesteps, device=xs.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(xs.shape[0])
        emb = timestep_embedding(timesteps, self.config.model_channels)
        emb = self.time_embed[2](F.silu(self.time_embed[0](emb)))

        x = xs
        skips = []
        for block in self.input_blocks:
            x = block(x, emb)
            skips.append(x)
        x = self.middle_block(x, emb)
        for block in self.output_blocks:
            x = block(torch.cat([x, skips.pop()], dim=1), emb)
        x = self.out[2](self.out[0](x))
        return x.float()
