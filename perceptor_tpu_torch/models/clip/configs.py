"""CLIP architecture configurations (a copy of
perceptor_tpu/models/clip/configs.py).

Mirrors the (architecture, weights) combinations documented in the reference
wrapper (reference perceptor/models/open_clip.py:22-44), the ModifiedResNet
and the ViT families. Config values follow the public open_clip model
configs for those names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    # vision (tuple vision_layers => ModifiedResNet, like openai CLIP)
    image_size: Tuple[int, int]
    patch_size: int
    vision_width: int
    vision_layers: object
    vision_heads: int
    # text
    context_length: int
    vocab_size: int
    text_width: int
    text_layers: int
    text_heads: int
    quick_gelu: bool = False

    @property
    def vision_head_dim(self) -> int:
        return self.vision_width // self.vision_heads

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))


def _vit(
    embed_dim,
    image,
    patch,
    v_width,
    v_layers,
    v_heads,
    t_width,
    t_layers,
    t_heads,
    quick_gelu=False,
):
    return CLIPConfig(
        embed_dim=embed_dim,
        image_size=(image, image),
        patch_size=patch,
        vision_width=v_width,
        vision_layers=v_layers,
        vision_heads=v_heads,
        context_length=77,
        vocab_size=49408,
        text_width=t_width,
        text_layers=t_layers,
        text_heads=t_heads,
        quick_gelu=quick_gelu,
    )


def _rn(embed_dim, image, v_width, v_layers, t_width, t_layers, t_heads,
        quick_gelu=False):
    """ModifiedResNet variants: attnpool heads = vision_width * 32 // 64."""
    return CLIPConfig(
        embed_dim=embed_dim,
        image_size=(image, image),
        patch_size=0,
        vision_width=v_width,
        vision_layers=tuple(v_layers),
        vision_heads=v_width * 32 // 64,
        context_length=77,
        vocab_size=49408,
        text_width=t_width,
        text_layers=t_layers,
        text_heads=t_heads,
        quick_gelu=quick_gelu,
    )


CONFIGS = {
    "RN50": _rn(1024, 224, 64, (3, 4, 6, 3), 512, 12, 8),
    "RN50-quickgelu": _rn(1024, 224, 64, (3, 4, 6, 3), 512, 12, 8, True),
    "RN101": _rn(512, 224, 64, (3, 4, 23, 3), 512, 12, 8),
    "RN101-quickgelu": _rn(512, 224, 64, (3, 4, 23, 3), 512, 12, 8, True),
    "RN50x4": _rn(640, 288, 80, (4, 6, 10, 6), 640, 12, 10),
    "RN50x16": _rn(768, 384, 96, (6, 8, 18, 8), 768, 12, 12),
    "RN50x64": _rn(1024, 448, 128, (3, 15, 36, 10), 1024, 12, 16),
    "ViT-B-32": _vit(512, 224, 32, 768, 12, 12, 512, 12, 8),
    "ViT-B-32-quickgelu": _vit(512, 224, 32, 768, 12, 12, 512, 12, 8, True),
    "ViT-B-16": _vit(512, 224, 16, 768, 12, 12, 512, 12, 8),
    "ViT-B-16-quickgelu": _vit(512, 224, 16, 768, 12, 12, 512, 12, 8, True),
    "ViT-B-16-plus-240": _vit(640, 240, 16, 896, 12, 14, 640, 12, 10),
    "ViT-L-14": _vit(768, 224, 14, 1024, 24, 16, 768, 12, 12),
    "ViT-L-14-quickgelu": _vit(768, 224, 14, 1024, 24, 16, 768, 12, 12, True),
    "ViT-L-14-336": _vit(768, 336, 14, 1024, 24, 16, 768, 12, 12),
    "ViT-L-14-336-quickgelu": _vit(768, 336, 14, 1024, 24, 16, 768, 12, 12, True),
    "ViT-H-14": _vit(1024, 224, 14, 1280, 32, 16, 1024, 24, 16),
    "ViT-g-14": _vit(1024, 224, 14, 1408, 40, 16, 1024, 24, 16),
    "ViT-bigG-14": _vit(1280, 224, 14, 1664, 48, 16, 1280, 32, 20),
}

# openai weights always use quickgelu regardless of the name suffix
OPENAI_QUICKGELU = True


def get_config(architecture: str, weights: str = "") -> CLIPConfig:
    name = architecture
    if name not in CONFIGS and name.endswith("-quickgelu"):
        base = name[: -len("-quickgelu")]
        if base in CONFIGS:
            return dataclasses.replace(CONFIGS[base], quick_gelu=True)
    if name not in CONFIGS:
        raise ValueError(
            f"Unknown CLIP architecture {architecture!r}; known: {sorted(CONFIGS)}"
        )
    config = CONFIGS[name]
    if weights == "openai" and not config.quick_gelu:
        config = dataclasses.replace(config, quick_gelu=True)
    return config
