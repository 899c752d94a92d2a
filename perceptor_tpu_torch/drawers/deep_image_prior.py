"""DeepImagePrior drawer (counterpart of
perceptor_tpu/drawers/deep_image_prior.py).

Its parameters are the skip net's (`models/deep_image_prior.py`), then the
additive residual `images`; the latents are a fixed buffer drawn from
`seed`. `synthesize()` = net(latents) + images; `loss()` is the L1 penalty
on the residual times 1e-4, which `engine.make_guidance_step` and
`run_on_device` add to the objective.
"""

from __future__ import annotations

import torch
from torch import nn

from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.models.deep_image_prior import DeepImagePrior as DIPModel
from perceptor_tpu_torch.models.deep_image_prior import offset_adam, offset_param_labels

RESIDUAL_PENALTY = 1e-4


class DeepImagePrior(DrawingInterface):
    def __init__(
        self,
        size,
        n_feature_channels: int = 64,
        output_channels: int = 3,
        seed: int = 0,
        fp16: bool = True,
        offset_type: str = "none",
        device="cuda",
    ):
        """`size` (H, W); the net as `models.DeepImagePrior` builds it from
        `seed`, on `device` (CUDA unless the caller passes "cpu")."""
        super().__init__()
        self.model = DIPModel(shape=(n_feature_channels, *size), output_channels=output_channels,
                              seed=seed, fp16=fp16, offset_type=offset_type, device=device)
        generator = torch.Generator(device=self.model.device).manual_seed(seed)
        self.register_buffer("latents", self.model.random_latents(generator))
        self.images = nn.Parameter(
            torch.zeros((1, output_channels, *size), device=self.model.device))

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        """The net's parameters first, then `images` (a module lists its own
        before its children's)."""
        named = list(super().named_parameters(prefix, recurse, remove_duplicate))
        images = (prefix + "." if prefix else "") + "images"
        yield from (item for item in named if item[0] != images)
        yield from (item for item in named if item[0] == images)

    def synthesize(self, params=None):
        """net(latents) + images, at the drawer's parameters or at `params`
        (tensors in the order of `parameters()`)."""
        if params is not None:
            names = [name for name, _ in self.named_parameters()]
            return torch.func.functional_call(self, dict(zip(names, params)), ())
        return self.model(self.latents) + self.images

    def loss(self, params=None):
        """The L1 residual penalty (reference :22-23)."""
        images = self.images if params is None else tuple(params)[-1]
        return images.abs().mean() * RESIDUAL_PENALTY

    def optimizer(self, learning_rate: float = 0.01):
        """`run_on_device`'s factory: Adam over `parameters()`, the net's
        offset branches at lr / 10."""
        return offset_adam(offset_param_labels(self.named_parameters()).values(), learning_rate)
