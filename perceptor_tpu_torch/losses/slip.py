"""SLIP guidance loss: the prompt bank's squared spherical distance over
`models.SLIP` (counterpart of perceptor_tpu/losses/slip.py)."""

from __future__ import annotations

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss


class SLIP(PromptBankLoss):
    def __init__(self, name="SLIP_VITB16", **kwargs):
        """`kwargs` go to `models.SLIP` (`tokenizer`, `precision`,
        `device`, `seed`)."""
        super().__init__(models.SLIP(name, **kwargs))
        self.name = name
