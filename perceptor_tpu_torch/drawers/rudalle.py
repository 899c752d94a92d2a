"""ruDALL-E's Gumbel-VQGAN drawer (counterpart of
perceptor_tpu/drawers/rudalle.py), NCHW.

The VQGAN is the CompVis encoder / decoder of the port's SD VAE
(`models/stable_diffusion/vae.py`, diffusers names) under the
vqgan.gumbelf8-sber config: ch 128, mult (1, 1, 2, 4), z 256, attention at
32 x 32 (encoder level 3, decoder level 0). At 256px its 512-channel
single-head AttnBlocks attend over 1,024 tokens, the flash kernels' site
(1, 1, 1024, 512): a decode launches the forward 4 times (the mid block
and three AttnBlocks), an encode 3 times (two AttnBlocks and the mid
block). Its quantizer keeps taming's names, `quantize.proj` and the
codebook `quantize.embed`. The encoder and decoder compute in bf16; the 1x1
`quant_conv`, `post_quant_conv` and `quantize.proj`, and the codebook, stay
fp32, as JAX's undtyped `nn.Conv`s and `embed` param compute (flax promotes
a bf16 input against fp32 params).

`BruteRuDalle`'s one parameter is the continuous latent `quant`, encoded
from the init images at construction; `synthesize()` decodes it. The DWT
variant's decoder emits 12 channels: a low band and three Haar high bands,
put together by `haar_idwt` at twice the decoder's resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, keep_fp32
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.models.stable_diffusion.config import VAEConfig
from perceptor_tpu_torch.models.stable_diffusion.vae import Decoder, Encoder
from perceptor_tpu_torch.ops.layers import Conv2d

GUMBEL_F8 = VAEConfig(
    latent_channels=256,  # z_channels
    channel_mults=(1, 1, 2, 4),
    double_z=False,
    scaling_factor=1.0,
    encoder_attn_levels=(3,),
    decoder_attn_levels=(0,),
)
TINY_GUMBEL = VAEConfig(
    latent_channels=16,
    base_channels=8,
    channel_mults=(1, 2),
    n_res_blocks=1,
    double_z=False,
    scaling_factor=1.0,
)

EMBED_DIM = 256
N_EMBED = 8192


def haar_idwt(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Inverse single-level 2D Haar (db1) DWT: low (N, C, H, W) and high
    (N, C, 3, H, W), bands (LH, HL, HH) as pytorch_wavelets orders them ->
    (N, C, 2H, 2W), each 2 x 2 output block [[a, c], [b, d]]."""
    ll = low
    lh, hl, hh = high[:, :, 0], high[:, :, 1], high[:, :, 2]
    a = (ll + lh + hl + hh) / 2.0
    b = (ll - lh + hl - hh) / 2.0
    c = (ll + lh - hl - hh) / 2.0
    d = (ll - lh - hl + hh) / 2.0
    # pixel_shuffle puts sub-channel 2 i + j at offset (i, j) of each block
    return F.pixel_shuffle(torch.stack([a, c, b, d], dim=2).flatten(1, 2), 2)


def haar_dwt(x: torch.Tensor):
    """Forward single-level Haar DWT, the inverse of `haar_idwt`: (N, C, H,
    W) -> (low (N, C, H/2, W/2), high (N, C, 3, H/2, W/2))."""
    blocks = F.pixel_unshuffle(x, 2).unflatten(1, (x.shape[1], 4))
    a, c_, b, d = blocks.unbind(2)
    ll = (a + b + c_ + d) / 2.0
    lh = (a - b + c_ - d) / 2.0
    hl = (a + b - c_ - d) / 2.0
    hh = (a - b - c_ + d) / 2.0
    return ll, torch.stack([lh, hl, hh], dim=2)


class GumbelQuantize(nn.Module):
    """taming's GumbelQuantize at inference: codebook logits by a 1x1
    `proj`, a straight-through one-hot over `embed`. Both stay fp32."""

    def __init__(self, embed_dim: int, n_embed: int):
        super().__init__()
        self.n_embed = n_embed
        self.proj = keep_fp32(Conv2d(embed_dim, n_embed, 1))
        self.embed = keep_fp32(nn.Embedding(n_embed, embed_dim))

    def forward(self, h: torch.Tensor, generator: Optional[torch.Generator] = None,
                temperature: float = 1.0) -> torch.Tensor:
        """h (N, embed_dim, H, W) -> quantized latents (N, embed_dim, H, W),
        fp32: argmax of the logits (plus Gumbel noise drawn from
        `generator`, if one is given) as the forward value, the softmax's
        gradient straight through."""
        logits = self.proj(h).permute(0, 2, 3, 1).float()
        if generator is not None:
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            logits = logits - torch.log(-torch.log(u + 1e-20) + 1e-20)
        logits = logits / temperature
        soft = torch.softmax(logits, dim=-1)
        hard = F.one_hot(logits.argmax(-1), self.n_embed).to(soft.dtype)
        one_hot = soft + (hard - soft).detach()
        quant = one_hot @ self.embed.weight.to(one_hot.dtype)
        return quant.permute(0, 3, 1, 2).float()


@dataclasses.dataclass(frozen=True)
class GumbelConfig:
    vae: VAEConfig = GUMBEL_F8
    embed_dim: int = EMBED_DIM
    n_embed: int = N_EMBED
    dwt: bool = False


class GumbelVQGAN(nn.Module):
    """Gumbel VQGAN: `encode` images in [-1, 1] to quantized latents,
    `decode` latents to images in [0, 1]."""

    def __init__(self, config: GumbelConfig):
        super().__init__()
        self.config = config
        cfg = config.vae
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(dataclasses.replace(cfg, in_channels=12 if config.dwt else 3))
        self.quant_conv = keep_fp32(Conv2d(cfg.latent_channels, config.embed_dim, 1))
        self.post_quant_conv = keep_fp32(Conv2d(config.embed_dim, cfg.latent_channels, 1))
        self.quantize = GumbelQuantize(config.embed_dim, config.n_embed)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.conv_in.weight.dtype

    def encode(self, xs: torch.Tensor, generator: Optional[torch.Generator] = None,
               temperature: float = 1.0) -> torch.Tensor:
        """xs (N, 3, H, W) in [-1, 1] -> quantized latents, fp32;
        deterministic without a `generator`."""
        h = self.quant_conv(self.encoder(xs.to(self.dtype)))
        return self.quantize(h, generator, temperature)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """quant (N, embed_dim, h, w) -> images in [0, 1], fp32."""
        h = self.post_quant_conv(quant.to(self.dtype))
        dec = self.decoder(h).float()
        if self.config.dwt:
            n, _, hh, ww = dec.shape
            dec = haar_idwt(dec[:, :3], dec[:, 3:].reshape(n, 3, 3, hh, ww))
        return (torch.clamp(dec, -1.0, 1.0) + 1.0) / 2.0

    def forward(self, xs: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(xs, generator))


class BruteRuDalle(DrawingInterface):
    def __init__(
        self,
        init_images,
        dwt: bool = False,
        tiny: bool = False,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        seed: int = 0,
    ):
        """The latent `quant`, encoded from `init_images` (N, 3, H, W) in
        [0, 1] with Gumbel noise from `generator` (none: the argmax code),
        is the drawer's parameter. The VQGAN (GUMBEL_F8, or TINY_GUMBEL with
        `tiny`), `drawer.model`, computes in bf16 on `device` (CUDA unless
        the caller passes "cpu"), frozen, with random weights from `seed`.
        A taming checkpoint loads through
        `model.load_state_dict(first_stage.convert_gumbel_vqgan(sd, cfg))`;
        `replace_(encode(images))` then re-encodes."""
        super().__init__()
        device = resolve_device(device)
        cfg = TINY_GUMBEL if tiny else GUMBEL_F8
        config = GumbelConfig(cfg, embed_dim=16 if tiny else EMBED_DIM,
                              n_embed=64 if tiny else N_EMBED, dwt=dwt)
        model = random_module(GumbelVQGAN, config, device,
                              torch.Generator(device=device).manual_seed(seed), COMPUTE_DTYPE)
        # kept out of the module tree: the VQGAN is no parameter of the drawer
        object.__setattr__(self, "model", model)
        if not isinstance(init_images, torch.Tensor):
            init_images = torch.from_numpy(np.asarray(init_images, dtype=np.float32))
        init_images = init_images.to(device=device, dtype=torch.float32)
        with torch.no_grad():
            self.quant = nn.Parameter(self.encode(init_images, generator))

    def synthesize(self, params=None):
        return self.decode(params if params is not None else self.quant)

    def encode(self, images, generator: Optional[torch.Generator] = None):
        """images in [0, 1] -> quantized latents."""
        return self.model.encode(images * 2.0 - 1.0, generator)

    def decode(self, latent):
        """latents -> images in [0, 1]."""
        return self.model.decode(latent)

