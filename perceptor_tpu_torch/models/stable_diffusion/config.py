"""Stable Diffusion architecture configs (a copy of
perceptor_tpu/models/stable_diffusion/config.py; the port imports nothing
of the JAX package).

Functional spec: reference perceptor/models/stable_diffusion/stable_diffusion.py:32-114
wraps diffusers' UNet2DConditionModel + AutoencoderKL for
CompVis/stable-diffusion-v1-4, runwayml/stable-diffusion-v1-5 and
runwayml/stable-diffusion-inpainting (9-channel UNet input,
conditioning.py:31-42). Configs are static dataclasses so tiny variants
compile quickly in hermetic tests.

Stable Diffusion XL base 1.0 (huggingface.co/stabilityai/
stable-diffusion-xl-base-1.0, `unet/`, `vae/`, `text_encoder/`,
`text_encoder_2/` configs) is the port's own: three levels, transformer
depth (-, 2, 10) by level and 10 in the mid block, heads of width 64,
linear `proj_in` / `proj_out`, the `text_time` added embedding (the
pooled text embedding and six size ids), and two text towers read at
their penultimate layer. Its entry in `MODEL_CONFIGS` holds a second text
config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


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
    # blocks per spatial transformer: one for every level, or one per level
    # (the mid block takes the last level's)
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    remat: bool = False  # recompute each res/transformer block in backward
    head_dim: Optional[int] = None  # heads = channels // head_dim; None: n_heads heads
    linear_projection: bool = False  # proj_in / proj_out as linears over tokens
    # the `text_time` added embedding: each size id a sinusoid of this width,
    # joined to the pooled text embedding (`added_input_dim` wide in all)
    added_time_dim: Optional[int] = None
    added_input_dim: Optional[int] = None

    @property
    def block_channels(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * m for m in self.channel_mults)

    def depth(self, level: int) -> int:
        d = self.transformer_depth
        return d if isinstance(d, int) else d[level]

    def heads(self, channels: int) -> int:
        return self.n_heads if self.head_dim is None else channels // self.head_dim


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
    quick_gelu: bool = True  # else the exact (erf) GELU
    penultimate: bool = False  # states of the last layer but one, no final LayerNorm
    projection_dim: Optional[int] = None  # `text_projection` of the pooled EOS state


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

SDXL_UNET = UNetConfig(
    channel_mults=(1, 2, 4),
    cross_attention=(False, True, True),
    context_dim=2048,
    transformer_depth=(0, 2, 10),
    head_dim=64,
    linear_projection=True,
    added_time_dim=256,
    added_input_dim=2816,  # 1280 pooled + 6 x 256
)
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
SDXL_TEXT = TextConfig(quick_gelu=True, penultimate=True)  # CLIP ViT-L/14
SDXL_TEXT_2 = TextConfig(  # OpenCLIP ViT-bigG/14
    width=1280, layers=32, heads=20, quick_gelu=False, penultimate=True, projection_dim=1280
)
SDXL_SIZE = 1024  # the size ids' default: original and target size, no crop

# tiny SDXL: depth (0, 1, 2) by level, heads of width 8, two towers
TINY_XL_UNET = UNetConfig(
    base_channels=32,
    channel_mults=(1, 2, 2),
    n_res_blocks=1,
    cross_attention=(False, True, True),
    context_dim=80,  # == TINY_XL_TEXT.width + TINY_XL_TEXT_2.width
    transformer_depth=(0, 1, 2),
    head_dim=8,
    linear_projection=True,
    added_time_dim=8,
    added_input_dim=88,  # 40 pooled + 6 x 8
)
TINY_XL_VAE = dataclasses.replace(TINY_VAE, scaling_factor=0.13025)
TINY_XL_TEXT = dataclasses.replace(TINY_TEXT, penultimate=True)
TINY_XL_TEXT_2 = dataclasses.replace(TINY_TEXT, width=48, quick_gelu=False, penultimate=True,
                                     projection_dim=40)


MODEL_CONFIGS = {
    "CompVis/stable-diffusion-v1-4": (SD_V1_UNET, SD_V1_VAE, SD_V1_TEXT),
    "runwayml/stable-diffusion-v1-5": (SD_V1_UNET, SD_V1_VAE, SD_V1_TEXT),
    "runwayml/stable-diffusion-inpainting": (SD_INPAINT_UNET, SD_V1_VAE, SD_V1_TEXT),
    "stabilityai/stable-diffusion-xl-base-1.0": (SDXL_UNET, SDXL_VAE, SDXL_TEXT, SDXL_TEXT_2),
}
