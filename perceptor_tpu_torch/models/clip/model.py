"""CLIP ViT image tower (counterpart of perceptor_tpu/models/clip/model.py
`VisionTransformer` and `CLIP.encode_image`).

Module names follow open_clip (`visual.conv1`, `visual.class_embedding`,
`visual.transformer.resblocks.{i}.attn.in_proj_weight`, ...), so the state
dict feeds the JAX package's `models/clip/convert.py from_openclip`.
Pre-LN transformer with a class token; LayerNorms in fp32 keep the
residual stream fp32 while every matmul runs in its weight's dtype. The
patch embedding is a stride = kernel convolution (non-overlapping patches).
The text tower is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.layers import Conv2d, LayerNorm, Linear


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Packed-qkv self-attention with nn.MultiheadAttention's param names."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        b, s, width = x.shape
        w = self.in_proj_weight
        qkv = F.linear(x.to(w.dtype), w, self.in_proj_bias.to(w.dtype))
        qkv = qkv.view(b, s, 3, self.heads, width // self.heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, width))


class MLP(nn.Module):
    def __init__(self, width: int, quick: bool):
        super().__init__()
        self.quick = quick
        self.c_fc = Linear(width, width * 4)
        self.c_proj = Linear(width * 4, width)

    def forward(self, x):
        h = self.c_fc(x)
        h = quick_gelu(h) if self.quick else F.gelu(h)
        return self.c_proj(h)


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick: bool):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width, quick)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualBlock(width, heads, quick) for _ in range(layers)]
        )

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        if cfg.is_resnet:
            raise NotImplementedError("only ViT CLIP image towers are ported")
        width, grid = cfg.vision_width, cfg.image_size[0] // cfg.patch_size
        self.patch_size = cfg.patch_size
        self.conv1 = Conv2d(3, width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, cfg.vision_layers, cfg.vision_heads, cfg.quick_gelu)
        self.ln_post = LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))

    def forward(self, images):
        """images (N, 3, H, W), already resized and normalized -> (N, embed) fp32."""
        h, w = images.shape[-2:]
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"image size ({h}, {w}) not divisible by patch {self.patch_size}")
        x = self.conv1(images)  # (N, width, gh, gw)
        n, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        dtype = x.dtype
        cls = self.class_embedding.to(dtype).expand(n, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0])
        return (x.to(self.proj.dtype) @ self.proj).float()


class CLIP(nn.Module):
    """The image side of CLIP: `visual` and `encode_image`."""

    def __init__(self, config: CLIPConfig):
        super().__init__()
        self.config = config
        self.visual = VisionTransformer(config)

    def encode_image(self, images):
        return self.visual(images)
