"""Multi-loss gradient combination (counterpart of
perceptor_tpu/utils/gradients.py).

One backward pass over the summed losses shares the synthesize prefix; what
remains are the helpers that combine per-loss gradients with respect to a
shared tensor."""

from __future__ import annotations

from typing import Sequence

import torch


def nonzero_mean(gradients, axis: int = 0) -> torch.Tensor:
    """Mean over `axis` counting only nonzero entries. Accepts a list of
    tensors (stacked along a new leading axis) or a tensor."""
    if isinstance(gradients, (list, tuple)):
        gradients = torch.stack(list(gradients))
    count = (gradients != 0).sum(dim=axis)
    return gradients.sum(dim=axis) / (count + 1e-6)


def nonzero_scale(tensor, axis=None) -> torch.Tensor:
    """Normalize by the std of the nonzero entries."""
    if isinstance(tensor, (list, tuple)):
        tensor = torch.stack(list(tensor))
    shape = tensor.shape
    if axis is None:
        flat, axis = tensor.reshape(-1), 0
    else:
        flat = tensor
    denom = (flat != 0).sum(dim=axis) + 1e-6
    mean_square = flat.square().sum(dim=axis) / denom
    mean = flat.sum(dim=axis) / denom
    std = torch.sqrt(torch.clamp(mean_square - mean.square(), min=0.0)) + 1e-6
    return (flat / (std.unsqueeze(axis) + 1e-6)).reshape(shape)


def combine_gradients(gradients: Sequence[torch.Tensor], mode: str = "sum") -> torch.Tensor:
    """Combine per-loss gradients w.r.t. a shared tensor into one update."""
    if mode == "sum":
        return sum(gradients[1:], gradients[0])
    if mode == "nonzero_mean":
        return nonzero_mean(list(gradients))
    if mode == "nonzero_scale_sum":
        scaled = [nonzero_scale(g) for g in gradients]
        return sum(scaled[1:], scaled[0])
    raise ValueError(f"unknown combine mode {mode!r}")
