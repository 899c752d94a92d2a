"""Rematerialization, the counterpart of flax's `nn.remat` in the JAX UNets.

A `Remat` block whose `remat` is set runs, while gradients are enabled,
under `torch.utils.checkpoint.checkpoint(use_reentrant=False)`: it keeps
only its inputs for the backward pass and runs its forward again there.
Without gradients (sampling) it runs as a plain module. Each UNet sets the
flag on its own blocks from its config's `remat` (`set_remat`), on the
blocks the JAX package wraps: SD's res and transformer blocks
(`stable_diffusion/unet.py:292-294`), ADM's res, transformer and attention
blocks (`guided_diffusion/unet.py:155-168`) and v-diffusion's conv blocks
(`velocity_diffusion/net.py:226-229`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


class Remat(nn.Module):
    """Base of a block that can recompute its activations in the backward
    pass; `remat` is False until `set_remat` sets it."""

    remat = False

    def __call__(self, *args, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(super().__call__, *args, use_reentrant=False, **kwargs)
        return super().__call__(*args, **kwargs)


def set_remat(module: nn.Module, remat: bool) -> None:
    """Set `remat` on every `Remat` block inside `module`."""
    for block in module.modules():
        if isinstance(block, Remat):
            block.remat = remat
