"""Stable Diffusion UNet (counterpart of
perceptor_tpu/models/stable_diffusion/unet.py `UNet`), NCHW.

Module names follow the diffusers UNet2DConditionModel state_dict
(`down_blocks.{i}.resnets.{j}`, `...attentions.{j}.transformer_blocks.0.attn1.to_q`,
...), so `convert.unet_state_dict_from_jax` and the JAX package's
`unet_from_diffusers` are inverse key maps. Every conv/linear computes in
its weight's dtype (bf16 storage = bf16 compute); GroupNorm/LayerNorm
statistics and the attention softmax run in fp32. The JAX `EMIT_LANE_PAD`
head-dim padding is TPU layout work: the port passes the true head_dim and
scale = 1/sqrt(dim_head). `forward` has the JAX UNet's DeepCache branch
(`cache` / `return_cache`, arXiv:2312.03209).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.remat import Remat, set_remat
from perceptor_tpu_torch.models.stable_diffusion.config import UNetConfig
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.conv_matmul import Conv3x3
from perceptor_tpu_torch.ops.groupnorm import GroupNormSiLU
from perceptor_tpu_torch.ops.layers import Conv2d, GroupNorm, LayerNorm, Linear
from perceptor_tpu_torch.ops.upsample_conv import nearest_upsample_2x
from perceptor_tpu_torch.parallel.plan import shard_spatial
from perceptor_tpu_torch.utils import profiling


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, [cos | sin] order, fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = F.pad(embedding, (0, 1))
    return embedding


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(Remat):
    """GN-SiLU-conv + time shift + GN-SiLU-conv with skip (diffusers
    ResnetBlock2D)."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.time_emb_proj = Linear(time_dim, out_channels)
        self.norm2 = GroupNormSiLU(out_channels)
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (
            Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x, emb):
        h = self.conv1(self.norm1(x))
        emb_out = self.time_emb_proj(F.silu(emb).to(self.time_emb_proj.weight.dtype))
        h = h + emb_out[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention, q from x, k/v from context (self-attention when
    context is None). `use_flash` None routes by `ops.attention.flash_route`;
    True/False force a route."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), nn.Identity()])
        self.use_flash: Optional[bool] = None

    def forward(self, x, context=None):
        context = x if context is None else context
        b, s, _ = x.shape
        sk = context.shape[1]

        def split(t, seq):
            return t.view(b, seq, self.heads, self.dim_head).transpose(1, 2)

        q = split(self.to_q(x), s)
        k = split(self.to_k(context), sk)
        v = split(self.to_v(context), sk)
        out = attention(q, k, v, scale=1.0 / math.sqrt(self.dim_head), use_flash=self.use_flash)
        out = out.transpose(1, 2).reshape(b, s, self.heads * self.dim_head)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward; `net.0.proj`, `net.2` as in diffusers."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(Remat):
    """GN -> proj_in -> transformer blocks over HW tokens -> proj_out +
    residual. The projections are 1x1 convolutions (SD-1.x) or, with
    `linear`, linears over the tokens (SDXL's `use_linear_projection`).
    Span `spatial_transformer`, `rows` the batch, `depth` the blocks and
    `tokens` H x W."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int, context_dim: int,
                 linear: bool = False):
        super().__init__()
        self.linear = linear
        proj = Linear if linear else (lambda c_in, c_out: Conv2d(c_in, c_out, 1))
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, dim_head, context_dim) for _ in range(depth)]
        )
        self.proj_out = proj(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        with profiling.annotate("spatial_transformer", rows=b,
                                depth=len(self.transformer_blocks), tokens=h * w):
            residual, x = x, self.norm(x)
            if self.linear:
                x = x.to(self.proj_in.weight.dtype).permute(0, 2, 3, 1).reshape(b, h * w, c)
                x = self.proj_in(x)
            else:
                x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
            for block in self.transformer_blocks:
                x = block(x, context)
            if self.linear:
                # the residual leads the add, so the output keeps its NCHW layout
                return residual + self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
            return self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2)) + residual


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(nearest_upsample_2x(x))


class _Level(nn.Module):
    """One down or up level: resnets (+ attentions) (+ resampler)."""

    def __init__(self, resnets, attentions, resampler, resampler_name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))


class UNet(nn.Module):
    """UNet2DConditionModel-compatible denoiser.

    forward(latents NCHW, timesteps (N,) or scalar, context (N, S, context_dim))
    -> predicted noise, NCHW fp32. A config with `added_time_dim` (SDXL's
    `text_time`) also takes `added=(pooled (N, P), size ids (N, 6))`: each
    id a sinusoid, joined to the pooled text embedding, through
    `add_embedding` and added to the timestep embedding.
    """

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        channels = cfg.block_channels
        time_dim = channels[0] * 4
        n_levels = len(channels)

        def transformer(ch, level):
            heads = cfg.heads(ch)
            return SpatialTransformer(
                ch, heads, ch // heads, cfg.depth(level), cfg.context_dim, cfg.linear_projection
            )

        self.time_embedding = TimestepEmbedding(channels[0], time_dim)
        if cfg.added_time_dim:
            self.add_embedding = TimestepEmbedding(cfg.added_input_dim, time_dim)
        self.conv_in = Conv3x3(cfg.in_channels, channels[0])

        skip_channels: List[int] = [channels[0]]
        down = []
        ch_in = channels[0]
        for i, ch in enumerate(channels):
            resnets, attentions = [], []
            for _ in range(cfg.n_res_blocks):
                resnets.append(ResnetBlock(ch_in, ch, time_dim))
                ch_in = ch
                if cfg.cross_attention[i]:
                    attentions.append(transformer(ch, i))
                skip_channels.append(ch)
            resampler = Downsample(ch) if i < n_levels - 1 else None
            if resampler is not None:
                skip_channels.append(ch)
            down.append(_Level(resnets, attentions, resampler, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        mid_ch = channels[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(mid_ch, mid_ch, time_dim), ResnetBlock(mid_ch, mid_ch, time_dim)]
        )
        self.mid_block.attentions = nn.ModuleList([transformer(mid_ch, n_levels - 1)])

        up = []
        for i in range(n_levels):
            level = n_levels - 1 - i
            ch = channels[level]
            resnets, attentions = [], []
            for _ in range(cfg.n_res_blocks + 1):
                resnets.append(ResnetBlock(ch_in + skip_channels.pop(), ch, time_dim))
                ch_in = ch
                if cfg.cross_attention[level]:
                    attentions.append(transformer(ch, level))
            resampler = Upsample(ch) if level > 0 else None
            up.append(_Level(resnets, attentions, resampler, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNormSiLU(channels[0])
        self.conv_out = Conv3x3(channels[0], cfg.out_channels)
        set_remat(self, cfg.remat)

    def forward(self, latents, timesteps, context, cache=None, return_cache=False, added=None):
        """Denoise. DeepCache: `return_cache=True` also returns the deep
        feature that enters the last (shallowest) up level, `(out, cache)`;
        `cache=<that feature>` skips down levels 1.., the mid block and up
        levels ..n-2, running conv_in, down level 0 (for its skips), the last
        up level on the cache and the head. The full path is unchanged. Span
        `unet`, `rows` the batch."""
        with profiling.annotate("unet", rows=latents.shape[0]):
            return self._forward(latents, timesteps, context, cache, return_cache, added)

    def _added_embedding(self, added, n: int) -> torch.Tensor:
        """`add_embedding` of the pooled text embeddings and the size ids."""
        if added is None:
            raise ValueError("this UNet's text_time embedding needs "
                             "added=(pooled text embeddings, size ids)")
        pooled, size_ids = added
        dim = self.config.added_time_dim
        ids = timestep_embedding(size_ids.reshape(-1), dim)
        return self.add_embedding(torch.cat([pooled.float(), ids.reshape(n, -1)], dim=-1))

    def _forward(self, latents, timesteps, context, cache, return_cache, added):
        if not torch.is_tensor(timesteps):
            timesteps = torch.tensor(timesteps, device=latents.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(latents.shape[0])
        emb = timestep_embedding(timesteps, self.config.block_channels[0])
        emb = self.time_embedding(emb)
        if self.config.added_time_dim:
            emb = emb + self._added_embedding(added, latents.shape[0])
        dtype = self.conv_in.weight.dtype
        context = context.to(dtype)

        # the context-parallel plan's record of the entry (parallel/plan.py)
        x = self.conv_in(shard_spatial(latents, h_axis=2))
        skips = [x]
        if cache is not None:
            self._down_level(self.down_blocks[0], x, emb, context, skips)
            x = self._up_level(self.up_blocks[-1], cache.to(dtype), emb, context, skips)
        else:
            for level in self.down_blocks:
                x = self._down_level(level, x, emb, context, skips)
                if hasattr(level, "downsamplers"):
                    x = level.downsamplers[0](x)
                    skips.append(x)

            x = self.mid_block.resnets[0](x, emb)
            x = self.mid_block.attentions[0](x, context)
            x = self.mid_block.resnets[1](x, emb)

            for level in self.up_blocks[:-1]:
                x = self._up_level(level, x, emb, context, skips)
            deep_feature = x
            x = self._up_level(self.up_blocks[-1], x, emb, context, skips)

        x = self.conv_out(self.conv_norm_out(x)).float()
        if return_cache:
            return x, (cache if cache is not None else deep_feature)
        return x

    @staticmethod
    def _down_level(level, x, emb, context, skips):
        """A down level's resnets (and transformers), each output a skip; the
        downsampler is the caller's."""
        for j, resnet in enumerate(level.resnets):
            x = resnet(x, emb)
            if hasattr(level, "attentions"):
                x = level.attentions[j](x, context)
            skips.append(x)
        return x

    @staticmethod
    def _up_level(level, x, emb, context, skips):
        for j, resnet in enumerate(level.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), emb)
            if hasattr(level, "attentions"):
                x = level.attentions[j](x, context)
        if hasattr(level, "upsamplers"):
            x = level.upsamplers[0](x)
        return x
