"""Clamp with feasibility-directed gradient (counterpart of
perceptor_tpu/ops/clamp.py): forward is an ordinary clamp; backward passes
the gradient only where it points back toward the feasible region,
grad_x = grad * (grad * (x - clamp(x)) >= 0)."""

from __future__ import annotations

import torch


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_value, max_value):
        ctx.save_for_backward(x)
        ctx.bounds = (min_value, max_value)
        return torch.clamp(x, min_value, max_value)

    @staticmethod
    def backward(ctx, grad_in):
        (x,) = ctx.saved_tensors
        clamped = torch.clamp(x, *ctx.bounds)
        keep = (grad_in * (x - clamped)) >= 0
        return grad_in * keep.to(grad_in.dtype), None, None


def clamp_with_grad(x: torch.Tensor, min_value=0.0, max_value=1.0) -> torch.Tensor:
    """Clamp to [min_value, max_value] (floats or broadcastable tensors)."""
    return _ClampWithGrad.apply(x, min_value, max_value)
