"""OpenAI ADM (guided diffusion) architecture configs (a copy of
perceptor_tpu/models/guided_diffusion/config.py; `remat` has no counterpart
in the port and is left out):
  "standard"  512px OpenAI/LAION finetune: 256ch, mult (0.5,1,1,2,2,4,4),
              attn at ds 16/32/64, head_channels 64, scale-shift norm,
              resblock up/down, learn_sigma.
  "pixelart"  256px PADexpanded: 128ch, mult (1,1,2,2,4,4), attn at ds 16,
              1 head, plain norm add, conv resample, learn_sigma.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ADMConfig:
    image_size: int
    model_channels: int
    channel_mult: Tuple[float, ...]
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (16,)  # downsample factors with attention
    num_heads: int = 1
    num_head_channels: int = -1  # overrides num_heads when > 0
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    in_channels: int = 3
    out_channels: int = 6  # learn_sigma
    # LDM extension (ldm/modules/diffusionmodules/openaimodel.py): replace
    # AttentionBlock with a cross-attention SpatialTransformer
    spatial_transformer: bool = False
    context_dim: int = 0
    transformer_depth: int = 1

    def heads_for(self, channels: int) -> int:
        if self.num_head_channels > 0:
            return channels // self.num_head_channels
        return self.num_heads


STANDARD = ADMConfig(
    image_size=512,
    model_channels=256,
    channel_mult=(0.5, 1, 1, 2, 2, 4, 4),
    attention_ds=(16, 32, 64),
    num_head_channels=64,
    use_scale_shift_norm=True,
    resblock_updown=True,
)

PIXELART = ADMConfig(
    image_size=256,
    model_channels=128,
    channel_mult=(1, 1, 2, 2, 4, 4),
    attention_ds=(16,),
)

TINY = ADMConfig(
    image_size=32,
    model_channels=16,
    channel_mult=(1, 2),
    num_res_blocks=1,
    attention_ds=(2,),
    num_head_channels=8,
    use_scale_shift_norm=True,
    resblock_updown=True,
)

MODEL_CONFIGS = {"standard": STANDARD, "pixelart": PIXELART, "tiny": TINY}
SHAPES = {"standard": (3, 512, 512), "pixelart": (3, 256, 256), "tiny": (3, 32, 32)}
