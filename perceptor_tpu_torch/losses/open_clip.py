"""OpenCLIP guidance loss (counterpart of perceptor_tpu/losses/open_clip.py).

The weights *name* is kept as `weights_name`, apart from the prompt bank's
`bank_weights` tensor.
"""

from __future__ import annotations

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss


class OpenCLIP(PromptBankLoss):
    def __init__(self, architecture="ViT-B-32", weights="laion2b_s34b_b79k", precision=None,
                 **kwargs):
        super().__init__(models.OpenCLIP(architecture, weights, precision, **kwargs))
        self.architecture = architecture
        self.weights_name = weights
