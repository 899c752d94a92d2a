"""k-diffusion's image denoiser for MonsterDiffusion, 48x48 sprites
(counterpart of perceptor_tpu/models/monster_diffusion/net.py), NCHW.

AdaGN (a conditioning -> per-sample GroupNorm scale and shift), GELU
ResConvBlocks, AdaGN-normed self-attention, fixed linear-blur FIR down- and
upsampling, Fourier time features plus a 9-dimensional augmentation
mapping. The published config: depths (2, 4, 4), channels (128, 256, 512),
self-attention at depths 1-2, heads of 64 channels, feats_in 256.

Module names follow the upstream torch model (`timestep_embed`,
`mapping_cond`, `mapping.{0,2}`, `proj_in`, `proj_out`,
`u_net.d_blocks.{i}.{j}` and `u_net.u_blocks.{i}.{j}` with the up blocks
stored innermost first, each ResConvBlock's layers under `main.{0,2,4,6}`
and `skip`, the resamplers' fixed `kernel` buffers), registered in its
order, so the JAX package's `monster_diffusion/convert.py from_torch` reads
this module's state_dict as a stream.

The conditioning and convs compute in their weights' dtype, GroupNorm
statistics and the softmax in fp32, the FIR resamplers in fp32; the net
returns fp32. Attention runs at 24 x 24 = 576 and 12 x 12 = 144 tokens,
which `flash_route` sends to the plain route: the net launches no flash
kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.models.velocity_diffusion.net import FourierFeatures
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.groupnorm import fused_group_norm_act
from perceptor_tpu_torch.ops.layers import Conv2d, Linear
from perceptor_tpu_torch.ops.upfirdn import fir_downsample_2x, fir_taps, fir_upsample_2x


@dataclasses.dataclass(frozen=True)
class MonsterConfig:
    in_channels: int = 3
    feats_in: int = 256
    depths: Tuple[int, ...] = (2, 4, 4)
    channels: Tuple[int, ...] = (128, 256, 512)
    self_attn_depths: Tuple[bool, ...] = (False, True, True)
    mapping_cond_dim: int = 9
    group_size: int = 32
    head_size: int = 64


TINY = MonsterConfig(
    feats_in=16, depths=(1, 1), channels=(16, 32), self_attn_depths=(False, True),
    group_size=8, head_size=16,
)
MODEL_CONFIGS = {"all": MonsterConfig(), "tiny-hero": MonsterConfig(), "tiny": TINY}


class AdaGN(nn.Module):
    """act(group_norm(x) * (1 + w) + b) with (w, b) mapped from `cond`, as
    one fused op (`ops/groupnorm.py`)."""

    def __init__(self, feats_in: int, channels: int, num_groups: int, activation: str = "none"):
        super().__init__()
        self.num_groups, self.activation = num_groups, activation
        self.mapper = Linear(feats_in, channels * 2)

    def forward(self, x, cond):
        weight, bias = self.mapper(cond).chunk(2, dim=-1)
        return fused_group_norm_act(x, weight + 1.0, bias, self.num_groups, 1e-5,
                                    self.mapper.weight.dtype, self.activation)


def _groups(channels: int, group_size: int) -> int:
    return max(1, channels // group_size)


class ResConvBlock(nn.Module):
    """AdaGN-GELU-conv3x3 twice, plus a 1x1 skip where the widths differ.
    The upstream `main` is a Sequential with GELU and dropout between the
    layers that hold weights; those keep their indices 0, 2, 4, 6."""

    def __init__(self, feats_in: int, c_in: int, c_mid: int, c_out: int, group_size: int):
        super().__init__()
        self.main = nn.ModuleDict({
            "0": AdaGN(feats_in, c_in, _groups(c_in, group_size), "gelu"),
            "2": Conv2d(c_in, c_mid, 3, padding=1),
            "4": AdaGN(feats_in, c_mid, _groups(c_mid, group_size), "gelu"),
            "6": Conv2d(c_mid, c_out, 3, padding=1),
        })
        self.skip = Conv2d(c_in, c_out, 1, bias=False) if c_in != c_out else nn.Identity()

    def forward(self, x, cond):
        h = self.main["2"](self.main["0"](x, cond))
        h = self.main["6"](self.main["4"](h, cond))
        return self.skip(x) + h


class SelfAttention2d(nn.Module):
    """AdaGN -> 1x1 qkv -> multi-head attention over the HW tokens -> 1x1
    out, plus the residual; the qkv channels are [q | k | v], head-major."""

    def __init__(self, feats_in: int, channels: int, n_head: int, num_groups: int):
        super().__init__()
        self.n_head = n_head
        self.norm_in = AdaGN(feats_in, channels, num_groups)
        self.qkv_proj = Conv2d(channels, channels * 3, 1)
        self.out_proj = Conv2d(channels, channels, 1)

    @staticmethod
    def _tokens_linear(conv: Conv2d, tokens):
        w = conv.weight
        return F.linear(tokens.to(w.dtype), w[:, :, 0, 0], conv.bias.to(w.dtype))

    def forward(self, x, cond):
        n, c, h, w = x.shape
        d = c // self.n_head
        tokens = self.norm_in(x, cond).reshape(n, c, h * w).transpose(1, 2)
        qkv = self._tokens_linear(self.qkv_proj, tokens).view(n, h * w, 3, self.n_head, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        y = attention(q, k, v, scale=1.0 / math.sqrt(d))
        y = self._tokens_linear(self.out_proj, y.transpose(1, 2).reshape(n, h * w, c))
        return x + y.transpose(1, 2).reshape(n, c, h, w).to(x.dtype)


class Downsample2d(nn.Module):
    """Reflect-padded stride-2 linear blur (`ops/upfirdn.py`); `kernel` is
    the upstream buffer, 2-D taps."""

    def __init__(self):
        super().__init__()
        self.register_buffer("kernel", torch.empty(4, 4))

    def reset_buffers(self) -> None:
        self.kernel.copy_(fir_taps("linear"))

    def forward(self, x):
        return fir_downsample_2x(x)


class Upsample2d(nn.Module):
    """Reflect-padded stride-2 transposed linear blur with the taps doubled
    (`ops/upfirdn.py`); `kernel` is the upstream buffer."""

    def __init__(self):
        super().__init__()
        self.register_buffer("kernel", torch.empty(4, 4))

    def reset_buffers(self) -> None:
        self.kernel.copy_(fir_taps("linear", gain=2.0))

    def forward(self, x):
        return fir_upsample_2x(x)


class _Blocks(nn.ModuleList):
    """A run of blocks; the ResConvBlocks and attention take `cond`."""

    def forward(self, x, cond):
        for block in self:
            x = block(x, cond) if isinstance(block, (ResConvBlock, SelfAttention2d)) else block(x)
        return x


def _block_run(cfg: MonsterConfig, i: int, c_in: int, c_out: int) -> list:
    """Level i's ResConvBlocks (c_in -> channels[i] ... -> c_out), each
    followed by self-attention at the deep levels."""
    c_mid, depth, blocks = cfg.channels[i], cfg.depths[i], []
    for j in range(depth):
        block_in = c_in if j == 0 else c_mid
        block_out = c_mid if j < depth - 1 else c_out
        blocks.append(ResConvBlock(cfg.feats_in, block_in, c_mid, block_out, cfg.group_size))
        if cfg.self_attn_depths[i]:
            blocks.append(SelfAttention2d(cfg.feats_in, block_out,
                                          _groups(block_out, cfg.head_size),
                                          _groups(block_out, cfg.group_size)))
    return blocks


class UNetBody(nn.Module):
    """Down blocks (each output kept as a skip), then up blocks, innermost
    first: all but the innermost take [x, skip] on the channels."""

    def __init__(self, cfg: MonsterConfig):
        super().__init__()
        levels = range(len(cfg.depths))
        # upstream DBlock: [Identity, Downsample2d below level 0, blocks]
        self.d_blocks = nn.ModuleList([
            _Blocks([nn.Identity(), *([Downsample2d()] if i > 0 else []),
                     *_block_run(cfg, i, cfg.channels[max(0, i - 1)], cfg.channels[i])])
            for i in levels
        ])
        # upstream UBlock: [blocks, Upsample2d above level 0]
        self.u_blocks = nn.ModuleList([
            _Blocks([*_block_run(cfg, i, cfg.channels[i] * (2 if i < len(levels) - 1 else 1),
                                 cfg.channels[max(0, i - 1)]),
                     *([Upsample2d()] if i > 0 else [])])
            for i in reversed(levels)
        ])

    def forward(self, x, cond):
        skips = []
        for block in self.d_blocks:
            x = block(x, cond)
            skips.append(x)
        for i, (block, skip) in enumerate(zip(self.u_blocks, reversed(skips))):
            x = block(x if i == 0 else torch.cat([x, skip.to(x.dtype)], dim=1), cond)
        return x


class MonsterUNet(nn.Module):
    """forward(xs (N, 3, H, W), time features (N,), mapping cond (N, 9))
    -> (N, 3, H, W) fp32. The inner model: the EDM preconditioning is the
    wrapper's (`monster_diffusion.py`)."""

    def __init__(self, cfg: MonsterConfig):
        super().__init__()
        self.config = cfg
        self.timestep_embed = FourierFeatures(1, cfg.feats_in)
        self.mapping_cond = Linear(cfg.mapping_cond_dim, cfg.feats_in, bias=False)
        self.mapping = nn.Sequential(
            Linear(cfg.feats_in, cfg.feats_in), nn.GELU(),
            Linear(cfg.feats_in, cfg.feats_in), nn.GELU(),
        )
        self.proj_in = Conv2d(cfg.in_channels, cfg.channels[0], 1)
        self.proj_out = Conv2d(cfg.channels[0], cfg.in_channels, 1)
        self.u_net = UNetBody(cfg)

    def forward(self, xs, time_features, mapping_cond: Optional[torch.Tensor] = None):
        if time_features.ndim == 0:
            time_features = time_features.expand(xs.shape[0])
        t_embed = self.timestep_embed(time_features.float()[:, None])
        cond = t_embed if mapping_cond is None else t_embed + self.mapping_cond(mapping_cond)
        cond = self.mapping(cond.to(self.proj_in.weight.dtype))
        x = self.u_net(self.proj_in(xs), cond)
        return self.proj_out(x).float()
