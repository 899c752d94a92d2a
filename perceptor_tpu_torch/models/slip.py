"""SLIP dual encoder: timm's ViT image tower and CLIP's text tower
(counterpart of perceptor_tpu/models/slip.py).

`TimmViT` is timm's vision_transformer: a stride = kernel patch
convolution with a bias, a class token, pre-LN blocks (LayerNorm eps 1e-6
in fp32, fused qkv, exact GELU), a final LayerNorm, pooled at the class
token in fp32. Its names are timm's (`patch_embed.proj`, `cls_token`,
`pos_embed`, `blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`,
`norm`); BLIP and LiT reuse it. The residual stream stays in the compute
dtype, as in the JAX tower.

`SLIPModule` holds `visual` (a `TimmViT`), the fp32 `image_projection` and
the text tower under open_clip's top-level names (`models/clip/model.py
TextTransformer`, exact GELU), so its state_dict feeds the JAX package's
`convert_slip` as it is. The `SLIP` wrapper normalizes images with timm's
ImageNet mean and std and L2-normalizes both towers; matmul weights are
stored in bf16 unless `precision="fp32"`, and the weights are seeded
random at the published widths. Memoized on its arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.clip.model import TextTransformer
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize
from perceptor_tpu_torch.models.dual_encoder import DualEncoder
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.layers import Conv2d, LayerNorm, Linear
from perceptor_tpu_torch.utils.cache import cache


@dataclasses.dataclass(frozen=True)
class SLIPConfig:
    embed_dim: int = 512
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12


_VIT = {
    "S": dict(vision_width=384, vision_layers=12, vision_heads=6),
    "B": dict(vision_width=768, vision_layers=12, vision_heads=12),
    "L": dict(vision_width=1024, vision_layers=24, vision_heads=16),
}

MODEL_CONFIGS = {
    "SLIP_VITS16": SLIPConfig(**_VIT["S"]),
    "SLIP_VITB16": SLIPConfig(**_VIT["B"]),
    "SLIP_VITL16": SLIPConfig(**_VIT["L"]),
    "CLIP_VITS16": SLIPConfig(**_VIT["S"]),
    "CLIP_VITB16": SLIPConfig(**_VIT["B"]),
    "CLIP_VITL16": SLIPConfig(**_VIT["L"]),
    "SLIP_CC3M": SLIPConfig(**_VIT["B"]),
    "SLIP_CC12M": SLIPConfig(**_VIT["B"]),
    "tiny": SLIPConfig(
        embed_dim=16, image_size=32, patch_size=16, vision_width=32,
        vision_layers=2, vision_heads=2, context_length=16, vocab_size=64,
        text_width=32, text_heads=2, text_layers=2,
    ),
}

IMAGE_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)  # timm / ImageNet
IMAGE_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class _PatchEmbed(nn.Module):
    def __init__(self, width: int, patch_size: int, bias: bool = True):
        super().__init__()
        self.proj = Conv2d(3, width, patch_size, stride=patch_size, bias=bias)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(width, width * 3)
        self.proj = Linear(width, width)

    def forward(self, x):
        b, s, width = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.heads, width // self.heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, s, width))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = Linear(width, width * 4)
        self.fc2 = Linear(width * 4, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=1e-6)
        self.attn = _Attention(width, heads)
        self.norm2 = LayerNorm(width, eps=1e-6)
        self.mlp = _MLP(width)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TimmViT(nn.Module):
    """timm vision_transformer, pooled at the class token."""

    def __init__(self, width: int, layers: int, heads: int, patch_size: int, image_size: int):
        super().__init__()
        self.patch_size = patch_size
        grid = image_size // patch_size
        self.patch_embed = _PatchEmbed(width, patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, width))
        self.blocks = nn.ModuleList([_Block(width, heads) for _ in range(layers)])
        self.norm = LayerNorm(width, eps=1e-6)

    def forward(self, images):
        """images (N, 3, H, W), already normalized -> (N, width) fp32."""
        h, w = images.shape[-2:]
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"image size ({h}, {w}) not divisible by patch {self.patch_size}")
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)
        n, _, width = x.shape
        cls = self.cls_token.to(x.dtype).expand(n, 1, width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed[0].to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)[:, 0].float()


class SLIPModule(TextTransformer):
    """`visual`, `image_projection` and the open_clip-named text tower."""

    fp32_params = ("image_projection",)

    def __init__(self, config: SLIPConfig):
        nn.Module.__init__(self)
        self.visual = TimmViT(config.vision_width, config.vision_layers, config.vision_heads,
                              config.patch_size, config.image_size)
        self.image_projection = nn.Parameter(torch.empty(config.vision_width, config.embed_dim))
        self._build_text(CLIPConfig(
            embed_dim=config.embed_dim, image_size=(config.image_size, config.image_size),
            patch_size=config.patch_size, vision_width=config.vision_width,
            vision_layers=config.vision_layers, vision_heads=config.vision_heads,
            context_length=config.context_length, vocab_size=config.vocab_size,
            text_width=config.text_width, text_layers=config.text_layers,
            text_heads=config.text_heads, quick_gelu=False,
        ))
        self.config = config

    def encode_image(self, images):
        return self.visual(images) @ self.image_projection


@cache
class SLIP(DualEncoder):
    _FAMILY = "slip"

    def __init__(
        self,
        name: str = "SLIP_VITB16",
        tokenizer: Optional[SimpleTokenizer] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        if name not in MODEL_CONFIGS:
            raise ValueError(f"unknown slip model: {name}")
        self.name = name
        self._build(SLIPModule, MODEL_CONFIGS[name], precision, device, seed,
                    IMAGE_MEAN, IMAGE_STD)
        self._tokenizer = tokenizer

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    @property
    def image_size(self):
        return (self.config.image_size, self.config.image_size)

    @torch.no_grad()
    def encode_texts(self, text_prompts) -> torch.Tensor:
        return self.encode_tokens(
            tokenize(text_prompts, self.config.context_length, tokenizer=self.tokenizer))

    @torch.no_grad()
    def encode_tokens(self, tokens) -> torch.Tensor:
        return _l2_normalize(self.module.encode_text(tokens))

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """Differentiable in `images`, (N, 3, H, W) in [0, 1]."""
        return _l2_normalize(self.module.encode_image(self.normalize(images, self.image_size)))
