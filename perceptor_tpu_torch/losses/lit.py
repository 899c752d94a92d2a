"""LiT guidance loss: the prompt bank's squared spherical distance over
`models.LiT` (counterpart of perceptor_tpu/losses/lit.py)."""

from __future__ import annotations

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss


class LiT(PromptBankLoss):
    def __init__(self, name="LiT-L16L", **kwargs):
        """`kwargs` go to `models.LiT` (`tokenizer`, `precision`,
        `device`, `seed`)."""
        super().__init__(models.LiT(name, **kwargs))
        self.name = name
