"""LDM first stages: the VQ autoencoder and the CompVis key map
(counterpart of perceptor_tpu/models/latent_diffusion/first_stage.py), NCHW.

The VQ stage shares the CompVis Encoder/Decoder backbone with the KL stage,
so the port's SD `vae.Encoder` and `vae.Decoder` serve both (diffusers
names). `VectorQuantizer` snaps latents to their nearest codebook entry with
a straight-through gradient; its distances are computed in fp32 and its
codebook stays fp32 when the rest is stored in bf16 (`cast_bf16_`), as the
JAX param does: near-ties flip codes when the arithmetic differs.
`convert_compvis_autoencoder` renames a CompVis first-stage state_dict
(`encoder.down.{i}.block.{j}`, decoder levels in reverse order, 1x1-conv
attention projections) onto the port's names, for the KL and VQ stages
alike; `convert_gumbel_vqgan` adds ruDALL-E's Gumbel quantizer to it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from perceptor_tpu_torch.core.dtypes import cast_matmul_params_bf16
from perceptor_tpu_torch.models.stable_diffusion.config import VAEConfig
from perceptor_tpu_torch.models.stable_diffusion.vae import Decoder, Encoder
from perceptor_tpu_torch.ops.layers import Conv2d

VQ_F4 = VAEConfig(
    latent_channels=3,
    channel_mults=(1, 2, 4),
    double_z=False,
    scaling_factor=1.0,
)
KL_F8 = VAEConfig(scaling_factor=1.0)  # LDM txt2img applies 0.18215 outside

TINY_VQ = VAEConfig(
    latent_channels=3,
    base_channels=16,
    channel_mults=(1, 2),
    n_res_blocks=1,
    double_z=False,
    scaling_factor=1.0,
)


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantization with straight-through gradients
    (taming-transformers VectorQuantizer2 inference semantics); the codebook
    under CompVis's name, `embedding.weight`."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """z (N, C, H, W) -> the nearest entry's index, (N, H, W), by
        ||z||^2 - 2 z.c + ||c||^2 in fp32."""
        n, _, h, w = z.shape
        flat = z.permute(0, 2, 3, 1).reshape(-1, self.embed_dim).float()
        codebook = self.embedding.weight.float()
        distances = (
            (flat**2).sum(1, keepdim=True)
            - 2 * flat @ codebook.T
            + (codebook**2).sum(1)[None]
        )
        return distances.argmin(1).reshape(n, h, w)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (N, C, H, W) -> quantized (N, C, H, W), gradient straight
        through to z."""
        quantized = self.embedding.weight.float()[self.indices(z)].permute(0, 3, 1, 2)
        return z + (quantized - z).detach()


class VQModel(nn.Module):
    """VQ autoencoder; images in [-1, 1] x-space at its boundary (the
    wrappers convert from [0, 1])."""

    def __init__(self, config: VAEConfig, n_embed: int = 8192):
        super().__init__()
        self.config = config
        lc = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2d(lc, lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)
        self.quantize = VectorQuantizer(n_embed, lc)

    def encode(self, xs: torch.Tensor) -> torch.Tensor:
        """xs (N, 3, H, W) in [-1, 1] -> continuous latents, fp32 (the LDM
        interface encodes without quantizing)."""
        return self.quant_conv(self.encoder(xs)).float()

    def decode(self, latents: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        """latents -> xs in [-1, 1], fp32; quantized first unless forced."""
        if not force_not_quantize:
            latents = self.quantize(latents)
        return self.decoder(self.post_quant_conv(latents)).float()

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(xs))


def cast_bf16_(vq: VQModel) -> VQModel:
    """bf16 storage for the matmul/conv weights of everything but the
    codebook, which stays fp32."""
    for name, child in vq.named_children():
        if name != "quantize":
            cast_matmul_params_bf16(child)
    return vq


def convert_compvis_autoencoder(
    state_dict: Dict, cfg: VAEConfig, prefix: str = "first_stage_model."
) -> Dict:
    """A CompVis autoencoder state_dict (keys under `prefix`) -> a
    state_dict for the port's `VQModel` (or, for a KL stage, its SD
    `AutoencoderKL`). The values pass through; the attention projections,
    1x1 convolutions in CompVis, become (C, C) linear weights.

    CompVis naming: encoder.down.{i}.block.{j}.{norm1,conv1,norm2,conv2,
    nin_shortcut}, encoder.down.{i}.attn.{j}.{norm,q,k,v,proj_out},
    encoder.down.{i}.downsample.conv, encoder.mid.{block_1,attn_1,block_2},
    encoder.norm_out, encoder.conv_out; the decoder mirrors it with up.{i}
    indexed in reverse level order.
    """
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out: Dict = {}

    def move(src, dst, squeeze=False):
        for suffix in ("weight", "bias"):
            if f"{src}.{suffix}" in sd:
                value = sd[f"{src}.{suffix}"]
                out[f"{dst}.{suffix}"] = value[:, :, 0, 0] if squeeze and suffix == "weight" else value

    def resnet(src, dst):
        for name in ("norm1", "conv1", "norm2", "conv2"):
            move(f"{src}.{name}", f"{dst}.{name}")
        move(f"{src}.nin_shortcut", f"{dst}.conv_shortcut")

    def attn(src, dst):
        move(f"{src}.norm", f"{dst}.group_norm")
        for old, new in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out.0")):
            move(f"{src}.{old}", f"{dst}.{new}", squeeze=True)

    def level(src, dst, n_blocks):
        for j in range(n_blocks):
            resnet(f"{src}.block.{j}", f"{dst}.resnets.{j}")
            if f"{src}.attn.{j}.q.weight" in sd:
                attn(f"{src}.attn.{j}", f"{dst}.attentions.{j}")

    n_levels = len(cfg.channel_mults)
    for part in ("encoder", "decoder"):
        move(f"{part}.conv_in", f"{part}.conv_in")
        resnet(f"{part}.mid.block_1", f"{part}.mid_block.resnets.0")
        resnet(f"{part}.mid.block_2", f"{part}.mid_block.resnets.1")
        if cfg.mid_attention:
            attn(f"{part}.mid.attn_1", f"{part}.mid_block.attentions.0")
        move(f"{part}.norm_out", f"{part}.conv_norm_out")
        move(f"{part}.conv_out", f"{part}.conv_out")
    for i in range(n_levels):
        level(f"encoder.down.{i}", f"encoder.down_blocks.{i}", cfg.n_res_blocks)
        if i < n_levels - 1:
            move(f"encoder.down.{i}.downsample.conv", f"encoder.down_blocks.{i}.downsamplers.0.conv")
        # the port's up_blocks run innermost first: up_blocks.{i} is up.{n - 1 - i}
        compvis = n_levels - 1 - i
        level(f"decoder.up.{compvis}", f"decoder.up_blocks.{i}", cfg.n_res_blocks + 1)
        if i < n_levels - 1:
            move(f"decoder.up.{compvis}.upsample.conv", f"decoder.up_blocks.{i}.upsamplers.0.conv")
    move("quant_conv", "quant_conv")
    move("post_quant_conv", "post_quant_conv")
    if "quantize.embedding.weight" in sd:
        out["quantize.embedding.weight"] = sd["quantize.embedding.weight"]
    return out


def convert_gumbel_vqgan(state_dict: Dict, cfg: VAEConfig) -> Dict:
    """A taming GumbelVQ state_dict (ruDALL-E's vqgan.gumbelf8-sber, or its
    DWT variant, whose keys carry a "model." prefix; a "state_dict" nesting
    is read too) -> a state_dict for `drawers.rudalle.GumbelVQGAN`: the
    CompVis backbone renamed by `convert_compvis_autoencoder`, the quantizer's
    `quantize.proj` and codebook `quantize.embed` under taming's own names."""
    state_dict = state_dict.get("state_dict", state_dict)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    out = convert_compvis_autoencoder(sd, cfg, prefix="")
    for key in ("quantize.proj.weight", "quantize.proj.bias", "quantize.embed.weight"):
        out[key] = sd[key]
    return out
