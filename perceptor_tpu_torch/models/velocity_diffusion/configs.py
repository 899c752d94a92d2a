"""v-diffusion (crowsonkb) UNet architecture configs (a copy of
perceptor_tpu/models/velocity_diffusion/configs.py; `remat` has no
counterpart in the port and is left out). The four published checkpoints:
  yfcc_2      (3,512,512)
  yfcc_1      (3,512,512)
  cc12m_1_cfg (3,256,256)  (CLIP-conditioned, FiLM modulation)
  wikiart     (3,256,256)

All four share one recursive topology: per level, `n_blocks` ResConvBlocks
down, a nested deeper level, a channel concat, `n_blocks` ResConvBlocks
up; the innermost level is a flat run of `n_inner` blocks. Self-attention
follows every block at the levels in `attn_levels` (heads = c/head_div).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """cc12m FiLM conditioning: CLIP embed (normalized,
    scaled by sqrt(dim)) + Fourier(t, 128) -> 2 ResLinearBlocks -> cond."""

    clip_dim: int = 512
    timestep_features: int = 128
    width: int = 1024
    clip_model: str = "ViT-B-16"


@dataclasses.dataclass(frozen=True)
class VNetConfig:
    image_size: Tuple[int, int]
    channels: Tuple[int, ...]  # per level, outermost first
    n_blocks: int  # blocks per level, each direction
    n_inner: int  # blocks at the innermost level
    attn_levels: Tuple[int, ...]  # levels with self-attention after each block
    head_div: int = 64  # heads = channels // head_div
    attn_norm: bool = True  # wikiart's SelfAttention2d has no input GroupNorm
    skip_first: bool = False  # wikiart cats [skip, main]; others [main, skip]
    timestep_input: str = "t"  # wikiart embeds log_snr(t) instead of t
    upsample_method: str = "bilinear"  # wikiart uses nearest
    timestep_features: int = 16
    fourier_std: float = 1.0
    in_channels: int = 3
    out_channels: int = 3
    mapping: Optional[MappingConfig] = None


YFCC_2 = VNetConfig(
    image_size=(512, 512),
    channels=(128, 256, 512, 512, 1024, 1024, 2048, 2048),
    n_blocks=2,
    n_inner=4,
    attn_levels=(5, 6, 7),
)

YFCC_1 = VNetConfig(
    image_size=(512, 512),
    channels=(128, 128, 256, 256, 512, 512, 1024, 1024),
    n_blocks=4,
    n_inner=8,
    attn_levels=(5, 6, 7),
)

CC12M_1_CFG = VNetConfig(
    image_size=(256, 256),
    channels=(128, 256, 256, 512, 512, 1024, 1024),
    n_blocks=4,
    n_inner=8,
    attn_levels=(4, 5, 6),
    mapping=MappingConfig(),
)

WIKIART = VNetConfig(
    image_size=(256, 256),
    channels=(64, 128, 256, 256, 512, 512, 1024),
    n_blocks=4,
    n_inner=8,
    attn_levels=(4, 5, 6),
    head_div=128,
    attn_norm=False,
    skip_first=True,
    timestep_input="log_snr",
    upsample_method="nearest",
    fourier_std=0.2,
)

TINY = VNetConfig(
    image_size=(32, 32),
    channels=(16, 32, 64),
    n_blocks=2,
    n_inner=2,
    attn_levels=(2,),
    head_div=32,
)

TINY_CONDITIONED = dataclasses.replace(
    TINY, mapping=MappingConfig(clip_dim=8, timestep_features=8, width=16)
)

MODEL_CONFIGS = {
    "yfcc_2": YFCC_2,
    "yfcc_1": YFCC_1,
    "cc12m_1_cfg": CC12M_1_CFG,
    "wikiart": WIKIART,
    "tiny": TINY,
    "tiny_conditioned": TINY_CONDITIONED,
}
