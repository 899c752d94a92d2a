"""LPIPS loss (counterpart of perceptor_tpu/losses/lpips.py)."""

from __future__ import annotations

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.lpips import LPIPS as LPIPSModel


class LPIPS(LossInterface):
    def __init__(self, name: str = "squeeze", linear_layers: bool = True,
                 spatial: bool = False, **kwargs):
        """squeeze / alex / vgg backbones; `kwargs` are `device` and `seed`
        of `models.lpips.LPIPS`."""
        self.model = LPIPSModel(name, linear_layers=linear_layers, spatial=spatial, **kwargs)

    def forward(self, images_a, images_b):
        """Pairwise distance; images (N, 3, H, W) in [0, 1]."""
        return self.model(images_a, images_b)
