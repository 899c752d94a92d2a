"""StyleGAN-XL drawer: the w latents are the parameter (counterpart of
perceptor_tpu/drawers/stylegan_xl.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perceptor_tpu_torch.drawers.interface import DrawingInterface


class StyleGANXL(DrawingInterface):
    def __init__(self, model=None, latents=None, name: str = "imagenet128", size: int = 1,
                 device="cuda", **latent_kwargs):
        """`model` (default `models.StyleGANXL(name, device)`), frozen and
        kept out of the module tree, so the w latents (N, num_ws, w_dim),
        fp32, are the drawer's one parameter: `latents` as given, else
        `model.latents(size, **latent_kwargs)`."""
        super().__init__()
        from perceptor_tpu_torch.models.stylegan_xl import StyleGANXL as Model

        model = model if model is not None else Model(name, device=device)
        object.__setattr__(self, "model", model)
        if latents is None:
            latents = model.latents(size, **latent_kwargs)
        if not isinstance(latents, torch.Tensor):
            latents = torch.from_numpy(np.array(latents, dtype=np.float32))
        self.latents = nn.Parameter(latents.to(device=model.device, dtype=torch.float32).clone())

    def synthesize(self, params=None):
        """Images in [0, 1] from the latents (or `params` in their place)."""
        return self.model(params if params is not None else self.latents)

    @property
    def model_params(self):
        return self.model.params

    def synthesize_fn(self, model_params, params):
        """`synthesize` with the generator's tensors taken from `model_params`."""
        return self.model.synthesis_fn(model_params, params)

    def encode(self, images):
        raise NotImplementedError(
            "StyleGAN-XL inversion is not supported (the reference drawer has no encode either)")
