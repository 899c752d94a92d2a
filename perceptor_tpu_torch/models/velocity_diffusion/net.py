"""v-diffusion UNet, crowsonkb family (counterpart of
perceptor_tpu/models/velocity_diffusion/net.py `VDiffusionUNet`), NCHW.

Nested skip levels (concat skip at each resolution), ResConvBlocks
(conv-relu-conv-relu + 1x1 skip), SelfAttention2d after the blocks of the
deep levels, FourierFeatures of the timestep broadcast as input planes and,
for the CLIP-conditioned cc12m model, FiLM modulation (ModConvBlock) from a
mapping network.

The upstream checkpoints are nested `nn.Sequential`s whose keys the JAX
package's `velocity_diffusion/convert.py from_torch` consumes as a stream,
in order, by suffix. This module registers its parameters in that same
order (the mapping network, the timestep embedding, then `blocks` in the
order the levels are walked; inside a block `main` before `skip`), under the
JAX module names, so `from_torch(module.state_dict(), cfg)` gives the flax
tree and `convert.vnet_state_dict_from_jax` is the inverse.

Every conv/linear computes in its weight's dtype; GroupNorm statistics and
the attention softmax run in fp32; FourierFeatures stay fp32; the UNet
returns fp32. The qkv 1x1 conv's channel order is [q | k | v]-major.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.remat import Remat, set_remat
from perceptor_tpu_torch.models.velocity_diffusion.configs import VNetConfig
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.groupnorm import fused_group_norm_act
from perceptor_tpu_torch.ops.layers import Conv2d, GroupNorm, Linear
from perceptor_tpu_torch.ops.upsample_conv import nearest_upsample_2x
from perceptor_tpu_torch.schedules.cosine import alpha_sigma_to_log_snr, t_to_alpha_sigma


class FourierFeatures(nn.Module):
    """f = 2 pi x W^T -> [cos f | sin f], fp32."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features // 2, in_features))

    def forward(self, x):
        f = 2 * math.pi * x.float() @ self.weight.float().T
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def _skip(cls, c_in: int, c_out: int, **kwargs):
    return cls(c_in, c_out, bias=False, **kwargs) if c_in != c_out else nn.Identity()


class ResConvBlock(Remat):
    """conv3x3-relu-conv3x3(-relu) + 1x1 skip."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, is_last: bool = False):
        super().__init__()
        self.is_last = is_last
        self.main = nn.ModuleDict({
            "conv1": Conv2d(c_in, c_mid, 3, padding=1),
            "conv2": Conv2d(c_mid, c_out, 3, padding=1),
        })
        self.skip = _skip(Conv2d, c_in, c_out, kernel_size=1)

    def forward(self, x, cond=None):
        h = self.main["conv2"](F.relu(self.main["conv1"](x)))
        if not self.is_last:
            h = F.relu(h)
        return self.skip(x) + h


class ModConvBlock(Remat):
    """cc12m FiLM block: conv, GroupNorm(1 group, no learned affine),
    per-sample scale-shift from `cond`, relu, twice, + 1x1 skip. Norm,
    modulation and relu are one fused op (`ops/groupnorm.py`)."""

    def __init__(self, c_in: int, c_mid: int, c_out: int, cond_dim: int, is_last: bool = False):
        super().__init__()
        self.is_last = is_last
        main = {
            "conv1": Conv2d(c_in, c_mid, 3, padding=1),
            "mod1_mod": Linear(cond_dim, c_mid * 2, bias=False),
            "conv2": Conv2d(c_mid, c_out, 3, padding=1),
        }
        if not is_last:
            main["mod2_mod"] = Linear(cond_dim, c_out * 2, bias=False)
        self.main = nn.ModuleDict(main)
        self.skip = _skip(Conv2d, c_in, c_out, kernel_size=1)

    def _modulate_relu(self, h, cond, name):
        scales, shifts = self.main[name](cond).chunk(2, dim=-1)
        return fused_group_norm_act(h, scales + 1.0, shifts, 1, 1e-5, h.dtype, "relu")

    def forward(self, x, cond):
        h = self._modulate_relu(self.main["conv1"](x), cond, "mod1_mod")
        h = self.main["conv2"](h)
        if not self.is_last:
            h = self._modulate_relu(h, cond, "mod2_mod")
        return self.skip(x) + h


class SelfAttention2d(nn.Module):
    """GN(1) -> 1x1 qkv -> multi-head attention over the HW tokens -> 1x1 out
    + residual. `use_flash` None routes by `ops.attention.flash_route`;
    True/False force a route."""

    def __init__(self, channels: int, n_head: int, use_norm: bool = True):
        super().__init__()
        self.n_head = n_head
        if use_norm:
            self.norm = GroupNorm(channels, eps=1e-5, num_groups=1)
        self.qkv_proj = Conv2d(channels, channels * 3, 1)
        self.out_proj = Conv2d(channels, channels, 1)
        self.use_flash: Optional[bool] = None

    @staticmethod
    def _tokens_linear(conv: Conv2d, tokens):
        w = conv.weight
        return F.linear(tokens.to(w.dtype), w[:, :, 0, 0], conv.bias.to(w.dtype))

    def forward(self, x, cond=None):
        n, c, h, w = x.shape
        d = c // self.n_head
        y = self.norm(x) if hasattr(self, "norm") else x
        tokens = y.reshape(n, c, h * w).transpose(1, 2)
        # (N, S, 3C) with channels [q(h0..hN) | k(h0..hN) | v(h0..hN)]
        qkv = self._tokens_linear(self.qkv_proj, tokens).view(n, h * w, 3, self.n_head, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        y = attention(q, k, v, scale=1.0 / math.sqrt(d), use_flash=self.use_flash)
        y = self._tokens_linear(self.out_proj, y.transpose(1, 2).reshape(n, h * w, c))
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class ResLinearBlock(nn.Module):
    """linear-relu-linear(-relu) + linear skip."""

    def __init__(self, f_in: int, f_mid: int, f_out: int, is_last: bool = False):
        super().__init__()
        self.is_last = is_last
        self.main = nn.ModuleDict({"fc1": Linear(f_in, f_mid), "fc2": Linear(f_mid, f_out)})
        self.skip = _skip(Linear, f_in, f_out)

    def forward(self, x):
        h = self.main["fc2"](F.relu(self.main["fc1"](x)))
        if not self.is_last:
            h = F.relu(h)
        return self.skip(x) + h


def _upsample(x, method: str):
    if method == "nearest":
        return nearest_upsample_2x(x)
    # half-pixel centres, as jax.image.resize "linear"
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


class VDiffusionUNet(nn.Module):
    """forward(diffused xs NCHW in [-1, 1], ts (N,), clip_embed?) -> v NCHW,
    fp32."""

    def __init__(self, config: VNetConfig):
        super().__init__()
        cfg = self.config = config
        cond_dim = None
        if cfg.mapping is not None:
            m = cfg.mapping
            cond_dim = m.width
            self.mapping_timestep_embed = FourierFeatures(1, m.timestep_features)
            self.mapping_0 = ResLinearBlock(m.clip_dim + m.timestep_features, m.width, m.width)
            self.mapping_1 = ResLinearBlock(m.width, m.width, m.width, is_last=True)
        self.timestep_embed = FourierFeatures(1, cfg.timestep_features)

        blocks = {}

        def add_block(name, c_in, c_mid, c_out, use_attn, is_last=False):
            if cond_dim is not None:
                blocks[name] = ModConvBlock(c_in, c_mid, c_out, cond_dim, is_last)
            else:
                blocks[name] = ResConvBlock(c_in, c_mid, c_out, is_last)
            if use_attn:
                blocks[f"{name}_attn"] = SelfAttention2d(
                    c_out, max(c_out // cfg.head_div, 1), use_norm=cfg.attn_norm
                )

        cs = cfg.channels
        n_levels = len(cs)

        def add_level(level, c_in):
            """Registers the level's blocks in walk order; returns its output
            channels."""
            c = cs[level]
            use_attn = level in cfg.attn_levels
            if level == n_levels - 1:
                for j in range(cfg.n_inner):
                    c_out = cs[level - 1] if j == cfg.n_inner - 1 else c
                    add_block(f"inner_{j}", c_in, c, c_out, use_attn)
                    c_in = c_out
                return c_in
            for j in range(cfg.n_blocks):
                add_block(f"down_{level}_{j}", c_in, c, c, use_attn)
                c_in = c
            c_in = add_level(level + 1, c) + c  # concat with the skip
            for j in range(cfg.n_blocks):
                last = j == cfg.n_blocks - 1
                if level == 0:
                    c_out, is_last = (cfg.out_channels if last else c), last
                else:
                    c_out, is_last = (cs[level - 1] if last else c), False
                add_block(f"up_{level}_{j}", c_in, c, c_out, use_attn, is_last)
                c_in = c_out
            return c_in

        add_level(0, cfg.in_channels + cfg.timestep_features)
        self.blocks = nn.ModuleDict(blocks)
        set_remat(self, cfg.remat)

    def _run(self, name, x, cond):
        x = self.blocks[name](x, cond)
        attn = f"{name}_attn"
        return self.blocks[attn](x) if attn in self.blocks else x

    def _run_level(self, level, x, cond):
        cfg = self.config
        if level == len(cfg.channels) - 1:
            for j in range(cfg.n_inner):
                x = self._run(f"inner_{j}", x, cond)
            return x
        for j in range(cfg.n_blocks):
            x = self._run(f"down_{level}_{j}", x, cond)
        skip = x
        x = self._run_level(level + 1, F.avg_pool2d(x, 2), cond)
        x = _upsample(x, cfg.upsample_method)
        x = torch.cat([skip, x] if cfg.skip_first else [x, skip], dim=1)
        for j in range(cfg.n_blocks):
            x = self._run(f"up_{level}_{j}", x, cond)
        return x

    def forward(self, xs, ts, clip_embed: Optional[torch.Tensor] = None):
        cfg = self.config
        ts = torch.as_tensor(ts, dtype=torch.float32, device=xs.device)
        if ts.ndim == 0:
            ts = ts.expand(xs.shape[0])

        dtype = next(iter(self.blocks.values())).main["conv1"].weight.dtype
        cond = None
        if cfg.mapping is not None:
            if clip_embed is None:
                raise ValueError("model is conditioned: pass clip_embed")
            # normalize * sqrt(dim)
            clip_embed = clip_embed.float()
            norm = torch.linalg.norm(clip_embed, dim=-1, keepdim=True)
            clip_embed = clip_embed / torch.clamp(norm, min=1e-12) * math.sqrt(cfg.mapping.clip_dim)
            t_embed = self.mapping_timestep_embed(ts[:, None])
            h = torch.cat([clip_embed, t_embed], dim=-1).to(dtype)
            cond = self.mapping_1(self.mapping_0(h))

        t_input = ts
        if cfg.timestep_input == "log_snr":
            t_input = alpha_sigma_to_log_snr(*t_to_alpha_sigma(t_input))
        t_planes = self.timestep_embed(t_input[:, None])

        n, _, h, w = xs.shape
        planes = t_planes.to(dtype)[:, :, None, None].expand(n, cfg.timestep_features, h, w)
        x = torch.cat([xs.to(dtype), planes], dim=1)
        return self._run_level(0, x, cond).float()
