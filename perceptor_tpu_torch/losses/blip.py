"""BLIP guidance loss: the prompt bank's squared spherical distance over
`models.BLIP` (counterpart of perceptor_tpu/losses/blip.py)."""

from __future__ import annotations

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss


class BLIP(PromptBankLoss):
    def __init__(self, name="model_base_retrieval_flickr", **kwargs):
        """`kwargs` go to `models.BLIP` (`tokenizer`, `precision`,
        `device`, `seed`)."""
        super().__init__(models.BLIP(name, **kwargs))
        self.name = name
