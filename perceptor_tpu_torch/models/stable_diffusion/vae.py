"""AutoencoderKL, the Stable Diffusion first stage (counterpart of
perceptor_tpu/models/stable_diffusion/vae.py), NCHW.

Module names follow the diffusers AutoencoderKL state_dict, so the port's
state_dict is a complete diffusers VAE. Public boundary: images NCHW in
[0, 1]; latents pre-scaled by `scaling_factor` (0.18215).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.models.stable_diffusion.config import VAEConfig
from perceptor_tpu_torch.models.stable_diffusion.unet import Upsample
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.conv_matmul import Conv3x3
from perceptor_tpu_torch.ops.groupnorm import GroupNormSiLU
from perceptor_tpu_torch.ops.layers import Conv2d, GroupNorm, Linear
from perceptor_tpu_torch.parallel.plan import shard_spatial


class ResnetBlock(nn.Module):
    """VAE residual block (no time embedding)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, eps=1e-6)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.norm2 = GroupNormSiLU(out_channels, eps=1e-6)
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (
            Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (head_dim = channels). At 512px
    the decoder's mid block attends over 4096 tokens with head_dim 512 and
    takes the flash kernels on a CUDA device."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels), nn.Identity()])
        self.use_flash: Optional[bool] = None

    def forward(self, x):
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).to(self.to_q.weight.dtype)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        out = attention(q[:, None], k[:, None], v[:, None], use_flash=self.use_flash)[:, 0]
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class MidBlock(nn.Module):
    def __init__(self, channels: int, use_attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels), ResnetBlock(channels, channels)])
        if use_attention:
            self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x)
        return self.resnets[1](x)


class _Level(nn.Module):
    def __init__(self, resnets, attentions, resampler, resampler_name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))

    def run_resnets(self, x):
        for j, resnet in enumerate(self.resnets):
            x = resnet(x)
            if hasattr(self, "attentions"):
                x = self.attentions[j](x)
        return x


class _Downsampler(nn.Module):
    """Stride-2 3x3 conv after an asymmetric (0, 1) pad of H and W."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        channels = cfg.block_channels
        self.conv_in = Conv3x3(cfg.in_channels, channels[0])
        levels, ch_in = [], channels[0]
        for i, ch in enumerate(channels):
            resnets, attentions = [], []
            for _ in range(cfg.n_res_blocks):
                resnets.append(ResnetBlock(ch_in, ch))
                ch_in = ch
                if i in cfg.encoder_attn_levels:
                    attentions.append(AttnBlock(ch))
            resampler = _Downsampler(ch) if i < len(channels) - 1 else None
            levels.append(_Level(resnets, attentions, resampler, "downsamplers"))
        self.down_blocks = nn.ModuleList(levels)
        self.mid_block = MidBlock(channels[-1], cfg.mid_attention)
        self.conv_norm_out = GroupNormSiLU(channels[-1], eps=1e-6)
        out_ch = (2 if cfg.double_z else 1) * cfg.latent_channels
        self.conv_out = Conv3x3(channels[-1], out_ch)

    def forward(self, x):
        x = self.conv_in(x)
        for level in self.down_blocks:
            x = level.run_resnets(x)
            if hasattr(level, "downsamplers"):
                x = level.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        channels = cfg.block_channels
        self.conv_in = Conv3x3(cfg.latent_channels, channels[-1])
        self.mid_block = MidBlock(channels[-1], cfg.mid_attention)
        levels, ch_in = [], channels[-1]
        for i, ch in enumerate(reversed(channels)):
            resnets, attentions = [], []
            for _ in range(cfg.n_res_blocks + 1):
                resnets.append(ResnetBlock(ch_in, ch))
                ch_in = ch
                if i in cfg.decoder_attn_levels:
                    attentions.append(AttnBlock(ch))
            resampler = Upsample(ch) if i < len(channels) - 1 else None
            levels.append(_Level(resnets, attentions, resampler, "upsamplers"))
        self.up_blocks = nn.ModuleList(levels)
        self.conv_norm_out = GroupNormSiLU(channels[0], eps=1e-6)
        self.conv_out = Conv3x3(channels[0], cfg.in_channels)

    def forward(self, x):
        x = self.mid_block(self.conv_in(x))
        for level in self.up_blocks:
            x = level.run_resnets(x)
            if hasattr(level, "upsamplers"):
                x = level.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """KL-VAE; `decode` is on the guided step's path, `encode` completes the
    diffusers state_dict."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv2d(config.latent_channels, config.latent_channels, 1)

    def moments(self, images):
        """images NCHW [0,1] -> (mean, logvar) of the latent posterior, fp32;
        logvar clipped to [-30, 20]."""
        h = self.quant_conv(self.encoder(shard_spatial(images * 2.0 - 1.0, h_axis=2)))
        mean, logvar = torch.chunk(h.float(), 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, images, generator: Optional[torch.Generator] = None):
        """Posterior sample (or its mode when `generator` is None), scaled."""
        mean, logvar = self.moments(images)
        if generator is not None:
            noise = torch.randn(
                mean.shape, generator=generator, device=mean.device, dtype=mean.dtype
            )
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.config.scaling_factor

    def decode(self, latents):
        """latents NCHW (scaled) -> images NCHW [0,1], fp32."""
        x = self.post_quant_conv(shard_spatial(latents / self.config.scaling_factor, h_axis=2))
        x = self.decoder(x)
        return (x.float() + 1.0) / 2.0

    def forward(self, images, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(images, generator))
