"""CLOOB dual encoder, ViT-B/16 (counterpart of perceptor_tpu/models/cloob.py).

Both towers are pre-LN transformers without a final LayerNorm, pooled at
token 0 and projected, their output L2-normalized in fp32. Names are
cloob-training's model_pt (`{image,text}_encoder.layers.{i}.attn.{norm,
query,key,value,out}`, `.ff.{norm,linear_0,linear_1}`, `embed`,
`pos_embed`, `class_embed`, `proj`), so the state_dict feeds the JAX
package's `convert_cloob` as it is. The image tower's patch convolution
has no bias.

The text tower masks QUERY positions, as the reference does: an additive
-1e30 on every score of a query past the row's first end-of-text token
(id vocab_size - 1), in fp32. Such a row's scores all round to -1e30, so it
attends uniformly and stays finite; keys are never masked. The `CLOOB`
wrapper resizes to 224px, normalizes with CLIP's mean and std; matmul
weights are stored in bf16 unless `precision="fp32"`. Memoized on its
arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.clip.model import checked_token_ids
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize
from perceptor_tpu_torch.models.dual_encoder import DualEncoder
from perceptor_tpu_torch.models.open_clip import CLIP_MEAN, CLIP_STD
from perceptor_tpu_torch.ops.attention import dot_product_attention
from perceptor_tpu_torch.ops.layers import Conv2d, LayerNorm, Linear
from perceptor_tpu_torch.utils.cache import cache


@dataclasses.dataclass(frozen=True)
class CLOOBConfig:
    d_embed: int = 512
    image_size: int = 224
    patch_size: int = 16
    vision_layers: int = 12
    vision_width: int = 768
    vision_heads: int = 12
    text_layers: int = 12
    text_width: int = 512
    text_heads: int = 8
    text_size: int = 77
    vocab_size: int = 49408

    @property
    def embed_dim(self) -> int:
        return self.d_embed


TINY = CLOOBConfig(
    d_embed=16, image_size=32, patch_size=16, vision_layers=2, vision_width=32,
    vision_heads=2, text_layers=2, text_width=32, text_heads=2, text_size=16,
    vocab_size=64,
)
CONFIGS = {"16-epochs": CLOOBConfig(), "32-epochs": CLOOBConfig(), "tiny": TINY}


class _SelfAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.norm = LayerNorm(width, eps=1e-5)
        self.query = Linear(width, width)
        self.key = Linear(width, width)
        self.value = Linear(width, width)
        self.out = Linear(width, width)


class _FeedForward(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.norm = LayerNorm(width, eps=1e-5)
        self.linear_0 = Linear(width, width * 4)
        self.linear_1 = Linear(width * 4, width)


class EncoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then x + ff(norm(x))."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attn = _SelfAttention(width)
        self.ff = _FeedForward(width)

    def forward(self, x, padding_mask=None):
        """x (N, S, width); `padding_mask` (N, S) bool, True on the
        positions whose queries attend normally."""
        b, s, width = x.shape
        attn = self.attn
        h = attn.norm(x)

        def split(layer):
            return layer(h).view(b, s, self.heads, width // self.heads).transpose(1, 2)

        mask = None
        if padding_mask is not None:
            mask = torch.where(padding_mask[:, None, :, None], 0.0, -1e30).float()
        out = dot_product_attention(split(attn.query), split(attn.key), split(attn.value),
                                    mask=mask)
        x = x + attn.out(out.transpose(1, 2).reshape(b, s, width))
        ff = self.ff
        return x + ff.linear_1(F.gelu(ff.linear_0(ff.norm(x))))


class CLOOBTextEncoder(nn.Module):
    def __init__(self, config: CLOOBConfig):
        super().__init__()
        self.config = config
        self.embed = nn.Embedding(config.vocab_size, config.text_width)
        self.pos_embed = nn.Embedding(config.text_size, config.text_width)
        self.layers = nn.ModuleList(
            [EncoderLayer(config.text_width, config.text_heads) for _ in range(config.text_layers)])
        self.proj = Linear(config.text_width, config.d_embed)

    def forward(self, tokens) -> torch.Tensor:
        """tokens (N, S) ids in [0, vocab_size) -> (N, d_embed), unit norm."""
        weight = self.embed.weight
        tokens = checked_token_ids(tokens, self.config.vocab_size, weight.device)
        eot_mask = tokens == self.config.vocab_size - 1
        # attended: the positions up to and including the first end-of-text
        padding_mask = (torch.cumsum(eot_mask.long(), dim=-1) == 0) | eot_mask
        x = self.embed(tokens) + self.pos_embed.weight[: tokens.shape[1]].to(weight.dtype)
        for layer in self.layers:
            x = layer(x, padding_mask)
        return _l2_normalize(self.proj(x[:, 0]).float())


class CLOOBImageEncoder(nn.Module):
    def __init__(self, config: CLOOBConfig):
        super().__init__()
        self.config = config
        grid = config.image_size // config.patch_size
        self.embed = Conv2d(3, config.vision_width, config.patch_size,
                            stride=config.patch_size, bias=False)
        self.class_embed = nn.Parameter(torch.empty(config.vision_width))
        self.pos_embed = nn.Embedding(grid * grid + 1, config.vision_width)
        self.layers = nn.ModuleList(
            [EncoderLayer(config.vision_width, config.vision_heads)
             for _ in range(config.vision_layers)])
        self.proj = Linear(config.vision_width, config.d_embed)

    def forward(self, images) -> torch.Tensor:
        """Normalized images (N, 3, H, W) -> (N, d_embed), unit norm."""
        patch = self.config.patch_size
        if images.shape[-2] % patch or images.shape[-1] % patch:
            raise ValueError(f"image size {tuple(images.shape[-2:])} not divisible by {patch}")
        x = self.embed(images).flatten(2).transpose(1, 2)
        n, _, width = x.shape
        cls = self.class_embed.to(x.dtype).expand(n, 1, width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.weight.to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        return _l2_normalize(self.proj(x[:, 0]).float())


class CLOOBModule(nn.Module):
    def __init__(self, config: CLOOBConfig):
        super().__init__()
        self.config = config
        self.image_encoder = CLOOBImageEncoder(config)
        self.text_encoder = CLOOBTextEncoder(config)


@cache
class CLOOB(DualEncoder):
    _FAMILY = "cloob"

    def __init__(
        self,
        name: str = "16-epochs",
        tokenizer: Optional[SimpleTokenizer] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        if name not in CONFIGS:
            raise ValueError(f"unknown cloob model: {name}")
        self.name = name
        self._build(CLOOBModule, CONFIGS[name], precision, device, seed, CLIP_MEAN, CLIP_STD)
        self.image_size = (self.config.image_size, self.config.image_size)
        self._tokenizer = tokenizer

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    @torch.no_grad()
    def encode_texts(self, text_prompts) -> torch.Tensor:
        return self.encode_tokens(
            tokenize(text_prompts, self.config.text_size, tokenizer=self.tokenizer))

    @torch.no_grad()
    def encode_tokens(self, tokens) -> torch.Tensor:
        return self.module.text_encoder(tokens)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """Differentiable in `images`, (N, 3, H, W) in [0, 1]."""
        return self.module.image_encoder(self.normalize(images, self.image_size))
