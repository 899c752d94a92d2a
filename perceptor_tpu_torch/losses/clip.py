"""CLIP guidance loss (counterpart of perceptor_tpu/losses/clip.py)."""

from __future__ import annotations

import json
import os

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss

_TEXTOFF_PATH = os.path.join(os.path.dirname(__file__), "vectors", "textoff.json")


class CLIP(PromptBankLoss):
    def __init__(self, name="ViT-B-32", precision=None, jit=None, **kwargs):
        """
        Args:
            name: CLIP model name (ViT-B-32, ViT-B-16, ViT-L-14, ViT-L-14-336, ...)
            jit: accepted for callers of the JAX package's signature and dropped
            kwargs: `config`, `tokenizer`, `device`, `seed` of `models.OpenCLIP`
        """
        del jit
        multiplier = 0.01 if name in ("ViT-L-14", "ViT-L-14-336") else 1.0
        super().__init__(models.CLIP(name, precision=precision, **kwargs), multiplier=multiplier)
        self.name = name

    def add_text_off_(self, weight=None):
        """Add the precomputed per-architecture "textoff" embedding."""
        if not os.path.exists(_TEXTOFF_PATH):
            raise ValueError(f"textoff vectors not available (expected {_TEXTOFF_PATH})")
        with open(_TEXTOFF_PATH) as f:
            textoff_json = json.load(f)
        if self.name not in textoff_json:
            raise ValueError(f"There is no textoff for this model: {self.name}")
        return self.add_encodings_(textoff_json[self.name], weight)
