"""TransformersOpenAICLIP guidance loss, the HF-layout CLIP's prompt bank
(counterpart of perceptor_tpu/losses/transformers_openai_clip.py)."""

from __future__ import annotations

from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss
from perceptor_tpu_torch.models.transformers_openai_clip import (
    TransformersOpenAICLIP as TransformersOpenAICLIPModel,
)


class TransformersOpenAICLIP(PromptBankLoss):
    def __init__(self, name="openai/clip-vit-large-patch14", **kwargs):
        """`kwargs` go to `models.TransformersOpenAICLIP`."""
        super().__init__(TransformersOpenAICLIPModel(name, **kwargs))
        self.name = name
