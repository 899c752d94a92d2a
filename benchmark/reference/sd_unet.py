"""Plain Stable Diffusion v1 UNet (diffusers `UNet2DConditionModel` with
CrossAttnDownBlock2D / DownBlock2D / UNetMidBlock2DCrossAttn / UpBlock2D /
CrossAttnUpBlock2D, `use_linear_projection` false), under diffusers'
state_dict names, in float32.

Configuration keys are those of the model's `unet/config.json`:
`in_channels`, `out_channels`, `block_out_channels`, `layers_per_block`,
`attention_head_dim` (in SD v1 the number of heads), `cross_attention_dim`,
`norm_num_groups`, `norm_eps`, `down_block_types`, `flip_sin_to_cos`,
`freq_shift`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Conv2d, Linear, attention, group_norm


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, shift: float):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - shift))
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups, eps):
        super().__init__()
        self.norm1 = group_norm(cin, eps, groups)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = Linear(temb_dim, cout)
        self.norm2 = group_norm(cout, eps, groups)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, heads, context_dim=None):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim, dim, bias=False)
        self.to_v = Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, s, dim = x.shape

        def heads(t):
            return t.reshape(b, t.shape[1], self.heads, dim // self.heads).transpose(1, 2)

        out = attention(heads(self.to_q(x)), heads(self.to_k(context)), heads(self.to_v(context)))
        return self.to_out[0](out.transpose(1, 2).reshape(b, s, dim))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Dropout(0.0), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, channels, heads, context_dim, groups):
        super().__init__()
        self.norm = group_norm(channels, 1e-6, groups)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class Block(nn.Module):
    """A down, mid or up block: `resnets`, optional `attentions`, optional
    `downsamplers` / `upsamplers`."""

    def __init__(self, resnets, attentions=None, resampler=None, resampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))


class Downsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        heads, ctx = cfg["attention_head_dim"], cfg["cross_attention_dim"]
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        cross = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        temb = 4 * ch[0]
        layers = cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb, groups, eps)

        down, skips, cin = [], [ch[0]], ch[0]
        for i, c in enumerate(ch):
            resnets = [resnet(cin if j == 0 else c, c) for j in range(layers)]
            attentions = [Transformer2DModel(c, heads, ctx, groups) for _ in range(layers)] \
                if cross[i] else None
            skips += [c] * layers
            last = i == len(ch) - 1
            if not last:
                skips.append(c)
            down.append(Block(resnets, attentions, None if last else Downsample2D(c),
                              "downsamplers"))
            cin = c
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block([resnet(ch[-1], ch[-1]), resnet(ch[-1], ch[-1])],
                               [Transformer2DModel(ch[-1], heads, ctx, groups)])
        up, cin = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            level = len(ch) - 1 - i
            resnets = []
            for _ in range(layers + 1):
                resnets.append(resnet(cin + skips.pop(), c))
                cin = c
            attentions = [Transformer2DModel(c, heads, ctx, groups) for _ in range(layers + 1)] \
                if cross[level] else None
            up.append(Block(resnets, attentions, Upsample2D(c) if level > 0 else None,
                            "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = group_norm(ch[0], eps, groups)
        self.conv_out = Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, context):
        """Noise prediction for latents `x` (N, C, h, w) at timesteps `t`
        (N,) under `context` (N, S, cross_attention_dim)."""
        cfg = self.cfg
        temb = self.time_embedding(timestep_embedding(
            t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"]))
        x = self.conv_in(x)
        skips = [x]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                x = res(x, temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
