"""LiT (locked-image tuning) dual encoder (counterpart of
perceptor_tpu/models/lit.py).

The image tower is a locked AugReg ViT (`models/slip.py TimmViT`) whose
class-token feature is the shared space; the text tower is BERT
(`models/blip.py BertTextEncoder`) with a linear `text_head` into that
space, in fp32. Images are scaled to [-1, 1]. Names are `image_tower.*`
(timm's), `text_tower.*` (HF-BERT's) and `text_head.*`, so the state_dict
feeds the JAX package's `convert_lit` as it is (a checkpoint's BERT
token-type embeddings are folded into the word embeddings there: the port
has none). Matmul weights are stored in bf16 unless `precision="fp32"`;
memoized on its arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from perceptor_tpu_torch.core.dtypes import keep_fp32
from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.blip import BertTextEncoder
from perceptor_tpu_torch.models.dual_encoder import DualEncoder
from perceptor_tpu_torch.models.latent_diffusion.bert import BERTTokenizer
from perceptor_tpu_torch.models.slip import TimmViT
from perceptor_tpu_torch.ops.layers import Linear
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.utils.cache import cache


@dataclasses.dataclass(frozen=True)
class LiTConfig:
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    vocab_size: int = 30522
    max_text_length: int = 16

    @property
    def embed_dim(self) -> int:
        # the locked image tower defines the space; the text head maps into it
        return self.vision_width


MODEL_CONFIGS = {
    # ViT-B/16 + BERT-base
    "LiT-B16B_2": LiTConfig(),
    # ViT-L/16 + BERT-large
    "LiT-L16L": LiTConfig(
        vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=1024, text_layers=24, text_heads=16,
    ),
    "tiny": LiTConfig(
        image_size=32, patch_size=16, vision_width=32, vision_layers=2,
        vision_heads=2, text_width=32, text_layers=2, text_heads=2,
        vocab_size=64, max_text_length=16,
    ),
}


class LiTModule(nn.Module):
    def __init__(self, config: LiTConfig):
        super().__init__()
        self.config = config
        self.image_tower = TimmViT(config.vision_width, config.vision_layers,
                                   config.vision_heads, config.patch_size, config.image_size)
        self.text_tower = BertTextEncoder(config)
        self.text_head = keep_fp32(Linear(config.text_width, config.embed_dim))

    def encode_text(self, tokens, attention_mask):
        return _l2_normalize(self.text_head(self.text_tower(tokens, attention_mask)[:, 0]))


@cache
class LiT(DualEncoder):
    def __init__(
        self,
        name: str = "LiT-L16L",
        tokenizer: Optional[BERTTokenizer] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        if name not in MODEL_CONFIGS:
            raise ValueError(f"unknown LiT model: {name}; known: {sorted(MODEL_CONFIGS)}")
        self.name = name
        self._build(LiTModule, MODEL_CONFIGS[name], precision, device, seed)
        self.image_size = (self.config.image_size, self.config.image_size)
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
        """Differentiable in `images`, (N, 3, H, W) in [0, 1]: resized,
        scaled to [-1, 1] (big_vision's value_range(-1, 1))."""
        images = resize(images, out_shape=self.image_size) * 2.0 - 1.0
        return _l2_normalize(self.module.image_tower(images))
