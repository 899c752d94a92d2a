"""BruteDiffusion drawer: the parameters are the diffused image at a fixed t
(counterpart of perceptor_tpu/drawers/brute_diffusion.py).

`synthesize` is the model's denoised prediction of the diffused image (in
[0, 1] space) at noise level `t`; `encode` q-samples an image to that level.
Works with any model that has `predictions(diffused, ts)` and
`diffuse(images, ts, ...)` (`models.VelocityDiffusion`). The model stays
frozen: only the diffused image is a parameter.
"""

from __future__ import annotations

import torch
from torch import nn

from perceptor_tpu_torch.drawers.interface import DrawingInterface


class BruteDiffusion(DrawingInterface):
    def __init__(self, model, diffused_images, t: float):
        super().__init__()
        # kept out of the module tree: the model is no parameter of the drawer
        object.__setattr__(self, "model", model)
        self.t = float(t)
        diffused_images = torch.as_tensor(diffused_images, dtype=torch.float32)
        self.diffused = nn.Parameter(diffused_images.detach().to(model.device).clone())

    @staticmethod
    def from_image(model, images, t, noise=None, generator=None) -> "BruteDiffusion":
        images = torch.as_tensor(images, dtype=torch.float32, device=model.device)
        drawer = BruteDiffusion(model, torch.zeros_like(images), t)
        return drawer.replace_(drawer.encode(images, noise=noise, generator=generator))

    @property
    def x(self):
        """Diffused state in [-1, 1] x-space."""
        return self.diffused * 2.0 - 1.0

    def _ts(self, params):
        return torch.full((params.shape[0],), self.t, device=params.device)

    def synthesize(self, params=None):
        params = params if params is not None else self.diffused
        return self.model.predictions(params, self._ts(params)).denoised_images

    def encode(self, images, noise=None, generator=None):
        return self.model.diffuse(images, self.t, noise=noise, generator=generator)

    def noise(self, params=None):
        """Predicted noise at the current state."""
        params = params if params is not None else self.diffused
        return self.model.predictions(params, self._ts(params)).predicted_noise
