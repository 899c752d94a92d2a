"""RuCLIP, Sber's Russian CLIP (counterpart of perceptor_tpu/models/ruclip.py).

OpenAI's CLIP architecture with QuickGELU (`models/clip/model.py`), except
that the text tower pools at the first `EOS_ID` token of each row, not at
its largest id. The tower's names are open_clip's, so its state_dict feeds
the JAX package's `from_openclip` as it is. Tokenization is the caller's:
youtokentome BPE with bos 2, eos 3 and pad 0 needs its bpe.model file, which
is not in the tree, so `tokenize` raises without a `tokenizer=` callable
texts -> (N, context_length) ids. Images are resized and normalized with
CLIP's mean and std. Matmul weights are stored in bf16 unless
`precision="fp32"`; memoized on its arguments.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.clip.model import CLIP, TextTransformer
from perceptor_tpu_torch.models.dual_encoder import DualEncoder
from perceptor_tpu_torch.models.open_clip import CLIP_MEAN, CLIP_STD
from perceptor_tpu_torch.utils.cache import cache

MODEL_CONFIGS = {
    # embed, resolution, v_layers, v_width, patch, ctx, vocab, t_width, t_heads, t_layers
    "ruclip-vit-base-patch32-224": (512, 224, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ruclip-vit-base-patch16-224": (512, 224, 12, 768, 16, 77, 49408, 512, 8, 12),
    "ruclip-vit-large-patch14-224": (768, 224, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "ruclip-vit-large-patch14-336": (768, 336, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "ruclip-vit-base-patch32-384": (512, 384, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ruclip-vit-base-patch16-384": (512, 384, 12, 768, 16, 77, 49408, 512, 8, 12),
    "tiny": (16, 32, 2, 32, 16, 16, 64, 32, 2, 2),
}

EOS_ID = 3


def ruclip_config(name: str) -> CLIPConfig:
    (embed, res, v_layers, v_width, patch, ctx, vocab, t_width, t_heads,
     t_layers) = MODEL_CONFIGS[name]
    return CLIPConfig(
        embed_dim=embed, image_size=(res, res), vision_layers=v_layers,
        vision_width=v_width, vision_heads=max(1, v_width // 64), patch_size=patch,
        context_length=ctx, vocab_size=vocab, text_width=t_width,
        text_heads=t_heads, text_layers=t_layers, quick_gelu=True,
    )


def first_eos(tokens):
    """Each row's first `EOS_ID` (position 0 where a row has none)."""
    return (tokens == EOS_ID).int().argmax(dim=-1)


class RuCLIPTextTransformer(TextTransformer):
    """CLIP's text tower pooled at each row's first `EOS_ID`."""

    eot_positions = staticmethod(first_eos)


class RuCLIPModule(CLIP):
    """Both towers and `logit_scale`, the text tower pooled at `EOS_ID`."""

    eot_positions = staticmethod(first_eos)


@cache
class RuCLIP(DualEncoder):
    def __init__(
        self,
        name: str = "ruclip-vit-base-patch32-224",
        tokenizer: Optional[Callable] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        """`tokenizer(texts) -> (N, ctx) int ids` with youtokentome's ids
        (bos 2, eos 3, pad 0)."""
        if name not in MODEL_CONFIGS:
            raise ValueError(f"unknown ruclip model: {name}")
        self.name = name
        self._build(RuCLIPModule, ruclip_config(name), precision, device, seed,
                    CLIP_MEAN, CLIP_STD)
        self._tokenizer = tokenizer

    @property
    def image_size(self):
        return self.config.image_size

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        if self._tokenizer is None:
            raise ValueError(
                "RuCLIP tokenization needs the youtokentome bpe.model; pass "
                "tokenizer= (a callable texts -> (N, ctx) int ids)"
            )
        return np.asarray(self._tokenizer(list(texts)), dtype=np.int64)

    @torch.no_grad()
    def encode_texts(self, text_prompts) -> torch.Tensor:
        return self.encode_tokens(self.tokenize(text_prompts))

    @torch.no_grad()
    def encode_tokens(self, tokens) -> torch.Tensor:
        return _l2_normalize(self.module.encode_text(tokens))

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """Differentiable in `images`, (N, 3, H, W) in [0, 1]."""
        return _l2_normalize(self.module.encode_image(self.normalize(images, self.image_size)))
