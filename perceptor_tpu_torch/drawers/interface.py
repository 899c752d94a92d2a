"""Drawer interface (counterpart of perceptor_tpu/drawers/interface.py).

A drawer is an `nn.Module` whose `nn.Parameter`s are what the optimizer
updates:

  - `synthesize(params=None) -> images`: the differentiable decode of the
    drawer's own parameters, or of `params` given in their place (a tensor
    or a sequence of tensors in the order of `parameters()`);
  - `encode(images) -> params`: project images into parameter space;
  - `replace_(params)`: copy new values into the parameters, in place.

A drawer with a penalty on its own parameters defines `loss(params=None)`;
`engine.make_guidance_step` adds it to the objective. Stochastic inits
take explicit seeds.
"""

from __future__ import annotations

import torch
from torch import nn


class DrawingInterface(nn.Module):
    def forward(self, params=None):
        return self.synthesize(params)

    def synthesize(self, params=None):
        raise NotImplementedError

    def encode(self, images):
        raise NotImplementedError

    @property
    def params(self):
        """The optimizable tensors: the one parameter, or a tuple of them."""
        params = tuple(self.parameters())
        return params[0] if len(params) == 1 else params

    @torch.no_grad()
    def replace_(self, params):
        """Copy new parameter values in; the `nn.Parameter`s (and any
        optimizer state keyed on them) stay the same objects."""
        if isinstance(params, torch.Tensor):
            params = (params,)
        own = tuple(self.parameters())
        if len(params) != len(own):
            raise ValueError(f"expected {len(own)} parameter tensors, got {len(params)}")
        for target, value in zip(own, params):
            target.copy_(torch.as_tensor(value, dtype=target.dtype, device=target.device))
        return self
