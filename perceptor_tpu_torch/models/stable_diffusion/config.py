"""Stable Diffusion architecture configs (a copy of
perceptor_tpu/models/stable_diffusion/config.py; the port imports nothing
of the JAX package).

Functional spec: reference perceptor/models/stable_diffusion/stable_diffusion.py:32-114
wraps diffusers' UNet2DConditionModel + AutoencoderKL for
CompVis/stable-diffusion-v1-4, runwayml/stable-diffusion-v1-5 and
runwayml/stable-diffusion-inpainting (9-channel UNet input,
conditioning.py:31-42). Configs are static dataclasses so tiny variants
compile quickly in hermetic tests.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 320
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    n_heads: int = 8
    context_dim: int = 768
    transformer_depth: int = 1
    remat: bool = False  # recompute each res/transformer block in backward

    @property
    def block_channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_mults)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    double_z: bool = True  # KL posterior (mean, logvar); False for VQ stages
    mid_attention: bool = True
    # taming-style per-resolution attention (levels with AttnBlocks after
    # each resnet); decoder levels are indexed innermost-first
    encoder_attn_levels: tuple = ()
    decoder_attn_levels: tuple = ()
    scaling_factor: float = 0.18215  # reference stable_diffusion.py:82-84,188-190

    @property
    def block_channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_mults)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """CLIP ViT-L/14 text tower (SD v1.x conditioning)."""

    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    context_length: int = 77


SD_V1_UNET = UNetConfig()
SD_INPAINT_UNET = UNetConfig(in_channels=9)
SD_V1_VAE = VAEConfig()
SD_V1_TEXT = TextConfig()

# Tiny hermetic-test variants (same topology, toy widths).
TINY_UNET = UNetConfig(
    base_channels=32,
    channel_mults=(1, 2),
    n_res_blocks=1,
    cross_attention=(True, False),
    n_heads=2,
    context_dim=32,  # == TINY_TEXT.width
)
TINY_INPAINT_UNET = dataclasses.replace(TINY_UNET, in_channels=9)
TINY_VAE = VAEConfig(base_channels=16, channel_mults=(1, 2), n_res_blocks=1)
TINY_TEXT = TextConfig(vocab_size=128, width=32, layers=2, heads=2, context_length=16)


MODEL_CONFIGS = {
    "CompVis/stable-diffusion-v1-4": (SD_V1_UNET, SD_V1_VAE, SD_V1_TEXT),
    "runwayml/stable-diffusion-v1-5": (SD_V1_UNET, SD_V1_VAE, SD_V1_TEXT),
    "runwayml/stable-diffusion-inpainting": (SD_INPAINT_UNET, SD_V1_VAE, SD_V1_TEXT),
}
