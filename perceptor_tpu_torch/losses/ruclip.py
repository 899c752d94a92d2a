"""RuCLIP guidance loss: the prompt bank's squared spherical distance over
`models.RuCLIP` (counterpart of perceptor_tpu/losses/ruclip.py)."""

from __future__ import annotations

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss


class RuCLIP(PromptBankLoss):
    def __init__(self, name="ruclip-vit-base-patch32-224", **kwargs):
        """`kwargs` go to `models.RuCLIP` (`tokenizer`, `precision`,
        `device`, `seed`)."""
        super().__init__(models.RuCLIP(name, **kwargs))
        self.name = name
