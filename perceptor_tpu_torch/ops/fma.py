"""Broadcasting fused multiply-add (counterpart of perceptor_tpu/ops/fma.py):
``fma(a, b, c) == a * b + c``. autograd reduces each gradient back to its
operand's shape, so the plain expression stands for StyleGAN's
custom-autograd op."""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with broadcasting; gradients un-broadcast to each operand."""
    return a * b + c
