"""CLOOB guidance loss: the prompt bank's squared spherical distance over
`models.CLOOB` (counterpart of perceptor_tpu/losses/cloob.py)."""

from __future__ import annotations

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss


class CLOOB(PromptBankLoss):
    def __init__(self, name="16-epochs", **kwargs):
        """`kwargs` go to `models.CLOOB` (`tokenizer`, `precision`,
        `device`, `seed`)."""
        super().__init__(models.CLOOB(name, **kwargs))
        self.name = name
