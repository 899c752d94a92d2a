"""BLIP image-text dual encoder (counterpart of perceptor_tpu/models/blip.py).

`BertTextEncoder` is BLIP's BERT in text mode under HF-BERT names
(`embeddings.{word_embeddings,position_embeddings,LayerNorm}`,
`encoder.layer.{i}.attention.self.{query,key,value}`,
`.attention.output.{dense,LayerNorm}`, `.intermediate.dense`,
`.output.{dense,LayerNorm}`): post-LN, LayerNorms eps 1e-12 in fp32, a
512-row position table, exact GELU, the word and position embeddings summed
in fp32, an additive key mask of -1e10 built in fp32. LiT reuses it.

`BLIPModule` holds `visual_encoder` (`models/slip.py TimmViT`),
`text_encoder` and the fp32 `vision_proj` / `text_proj` heads, so its
state_dict feeds the JAX package's `convert_blip` as it is. The `BLIP`
wrapper resizes images to the tower's size (antialiased), normalizes them
with CLIP's mean and std, and L2-normalizes each projection twice, as the
reference does. Tokens come from the port's WordPiece `BERTTokenizer`,
which needs a vocabulary (`tokenizer=`, or a vocab file on disk). Memoized
on its arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import keep_fp32
from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.clip.model import checked_token_ids
from perceptor_tpu_torch.models.dual_encoder import DualEncoder
from perceptor_tpu_torch.models.latent_diffusion.bert import BERTTokenizer
from perceptor_tpu_torch.models.open_clip import CLIP_MEAN, CLIP_STD
from perceptor_tpu_torch.models.slip import TimmViT
from perceptor_tpu_torch.ops.attention import dot_product_attention
from perceptor_tpu_torch.ops.layers import LayerNorm, Linear
from perceptor_tpu_torch.utils.cache import cache


@dataclasses.dataclass(frozen=True)
class BLIPConfig:
    image_size: int = 384
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 256
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    vocab_size: int = 30524  # bert-base-uncased + [DEC]/[ENC] tokens
    max_text_length: int = 35


_BASE = dict(vision_width=768, vision_layers=12, vision_heads=12)
_LARGE = dict(vision_width=1024, vision_layers=24, vision_heads=16)

MODEL_CONFIGS = {
    "model_base_retrieval_coco": BLIPConfig(**_BASE),
    "model_large_retrieval_coco": BLIPConfig(**_LARGE),
    "model_base_retrieval_flickr": BLIPConfig(**_BASE),
    "model_large_retrieval_flickr": BLIPConfig(**_LARGE),
    "model_large": BLIPConfig(**_LARGE),
    "model*_base": BLIPConfig(**_BASE),
    "model_base": BLIPConfig(image_size=224, **_BASE),
    "model_base_capfilt_large": BLIPConfig(**_BASE),
    "tiny": BLIPConfig(
        image_size=32, patch_size=16, vision_width=32, vision_layers=2,
        vision_heads=2, embed_dim=16, text_width=32, text_layers=2,
        text_heads=2, vocab_size=64, max_text_length=16,
    ),
}

POSITIONS = 512


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, width: int):
        super().__init__()
        self.word_embeddings = keep_fp32(nn.Embedding(vocab_size, width))
        self.position_embeddings = keep_fp32(nn.Embedding(POSITIONS, width))
        self.LayerNorm = LayerNorm(width, eps=1e-12)


class _SelfAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.query = Linear(width, width)
        self.key = Linear(width, width)
        self.value = Linear(width, width)


class _Output(nn.Module):
    def __init__(self, width_in: int, width: int):
        super().__init__()
        self.dense = Linear(width_in, width)
        self.LayerNorm = LayerNorm(width, eps=1e-12)


class _Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.self = _SelfAttention(width)
        self.output = _Output(width, width)


class _Intermediate(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.dense = Linear(width, width * 4)


class _Layer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = _Attention(width)
        self.intermediate = _Intermediate(width)
        self.output = _Output(width * 4, width)

    def forward(self, x, key_mask):
        b, s, width = x.shape
        dtype = self.attention.self.query.weight.dtype

        def split(layer):
            return layer(x).view(b, s, self.heads, width // self.heads).transpose(1, 2)

        qkv = self.attention.self
        attn = dot_product_attention(split(qkv.query), split(qkv.key), split(qkv.value),
                                     mask=key_mask)
        attn = self.attention.output.dense(attn.transpose(1, 2).reshape(b, s, width))
        x = self.attention.output.LayerNorm(x + attn).to(dtype)
        h = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + h).to(dtype)


class _Encoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.layer = nn.ModuleList([_Layer(width, heads) for _ in range(layers)])


class BertTextEncoder(nn.Module):
    """Post-LN BERT encoder (BLIP's med.py BertModel in text mode)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config.vocab_size, config.text_width)
        self.encoder = _Encoder(config.text_width, config.text_layers, config.text_heads)

    def forward(self, tokens, attention_mask) -> torch.Tensor:
        """tokens (N, S) ids in [0, vocab_size), attention_mask (N, S), 1 on
        the tokens to attend -> (N, S, width) fp32."""
        embeddings = self.embeddings
        weight = embeddings.word_embeddings.weight
        tokens = checked_token_ids(tokens, self.config.vocab_size, weight.device)
        x = F.embedding(tokens, weight) + embeddings.position_embeddings.weight[: tokens.shape[1]]
        x = embeddings.LayerNorm(x).to(self.encoder.layer[0].attention.self.query.weight.dtype)
        attention_mask = torch.as_tensor(attention_mask, device=weight.device)
        key_mask = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e10).float()
        for layer in self.encoder.layer:
            x = layer(x, key_mask)
        return x.float()


class BLIPModule(nn.Module):
    """`visual_encoder`, `text_encoder`, `vision_proj` and `text_proj`."""

    def __init__(self, config: BLIPConfig):
        super().__init__()
        self.config = config
        self.visual_encoder = TimmViT(config.vision_width, config.vision_layers,
                                      config.vision_heads, config.patch_size, config.image_size)
        self.text_encoder = BertTextEncoder(config)
        self.vision_proj = keep_fp32(Linear(config.vision_width, config.embed_dim))
        self.text_proj = keep_fp32(Linear(config.text_width, config.embed_dim))

    def encode_image(self, images):
        """Normalized images -> twice L2-normalized (N, embed_dim) fp32."""
        return _l2_normalize(_l2_normalize(self.vision_proj(self.visual_encoder(images))))

    def encode_text(self, tokens, attention_mask):
        cls = self.text_encoder(tokens, attention_mask)[:, 0]
        return _l2_normalize(_l2_normalize(self.text_proj(cls)))


@cache
class BLIP(DualEncoder):
    _FAMILY = "blip"

    def __init__(
        self,
        name: str = "model_base_retrieval_flickr",
        tokenizer: Optional[BERTTokenizer] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        if name not in MODEL_CONFIGS:
            raise ValueError(f"unknown blip model: {name}")
        self.name = name
        self._build(BLIPModule, MODEL_CONFIGS[name], precision, device, seed,
                    CLIP_MEAN, CLIP_STD)
        self.image_size = self.config.image_size
        self._tokenizer = tokenizer

    @property
    def tokenizer(self) -> BERTTokenizer:
        if self._tokenizer is None:
            self._tokenizer = BERTTokenizer(max_length=self.config.max_text_length)
        return self._tokenizer

    @torch.no_grad()
    def encode_texts(self, texts) -> torch.Tensor:
        tokens = self.tokenizer(list(texts))
        return self.encode_tokens(tokens, tokens != self.tokenizer.pad)

    @torch.no_grad()
    def encode_tokens(self, tokens, attention_mask) -> torch.Tensor:
        return self.module.encode_text(tokens, attention_mask)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """Differentiable in `images`, (N, 3, H, W) in [0, 1]."""
        size = (self.image_size, self.image_size)
        return self.module.encode_image(self.normalize(images, size))

    @staticmethod
    def image_text_contrastive_spherical_distance(encodings_a, encodings_b) -> torch.Tensor:
        """(len(b), len(a)) squared spherical distances (reference
        blip.py:115-123)."""
        norm = torch.linalg.norm(encodings_a[None, :] - encodings_b[:, None], dim=-1)
        return torch.square(torch.arcsin(torch.clamp(norm / 2, 0.0, 1.0))) * 2
