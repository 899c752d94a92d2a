"""Plain KL autoencoder of Stable Diffusion (diffusers `AutoencoderKL`:
DownEncoderBlock2D / UpDecoderBlock2D, a mid block with one single-head
attention), under diffusers' state_dict names, in float32. Only the
decoder runs; the encoder is built so that the state_dict is whole.

Configuration keys are those of the model's `vae/config.json`:
`in_channels`, `latent_channels`, `block_out_channels`, `layers_per_block`,
`norm_num_groups`, `scaling_factor`. Images cross the boundary in [0, 1]
as `(decoder output + 1) / 2`, unclamped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Conv2d, Linear, attention, group_norm
from benchmark.reference.sd_unet import Block, Upsample2D

EPS = 1e-6


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = group_norm(cin, EPS, groups)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = group_norm(cout, EPS, groups)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over the H W positions, head_dim = C."""

    def __init__(self, channels, groups):
        super().__init__()
        self.group_norm = group_norm(channels, EPS, groups)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y))[:, 0]
        return self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid_block(c, groups):
    return Block([ResnetBlock2D(c, c, groups), ResnetBlock2D(c, c, groups)],
                 [AttentionBlock(c, groups)])


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, groups, layers = cfg["block_out_channels"], cfg["norm_num_groups"], \
            cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        blocks, cin = [], ch[0]
        for i, c in enumerate(ch):
            resnets = [ResnetBlock2D(cin if j == 0 else c, c, groups) for j in range(layers)]
            last = i == len(ch) - 1
            blocks.append(Block(resnets, None, None if last else Downsample(c), "downsamplers"))
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(ch[-1], groups)
        self.conv_norm_out = group_norm(ch[-1], EPS, groups)
        self.conv_out = Conv2d(ch[-1], 2 * cfg["latent_channels"], 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch, groups, layers = cfg["block_out_channels"], cfg["norm_num_groups"], \
            cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["latent_channels"], ch[-1], 3, padding=1)
        self.mid_block = _mid_block(ch[-1], groups)
        blocks, cin = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            resnets = []
            for _ in range(layers + 1):
                resnets.append(ResnetBlock2D(cin, c, groups))
                cin = c
            last = i == len(ch) - 1
            blocks.append(Block(resnets, None, None if last else Upsample2D(c), "upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = group_norm(ch[0], EPS, groups)
        self.conv_out = Conv2d(ch[0], cfg["in_channels"], 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))
        for block in self.up_blocks:
            for res in block.resnets:
                x = res(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        latent = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * latent, 2 * latent, 1)
        self.post_quant_conv = Conv2d(latent, latent, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> images in [0, 1] (unclamped)."""
        x = self.decoder(self.post_quant_conv(latents / self.cfg["scaling_factor"]))
        return (x + 1.0) / 2.0
