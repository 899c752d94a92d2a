"""Bias + activation + gain + clamp (counterpart of
perceptor_tpu/ops/bias_act.py): StyleGAN's nine activations with their
default alpha and gain, in the input's dtype; autograd gives the
gradients."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# name -> (fn(x, alpha), default alpha, default gain)
ACTIVATIONS = {
    "linear": (lambda x, a: x, 0.0, 1.0),
    "relu": (lambda x, a: F.relu(x), 0.0, math.sqrt(2)),
    "lrelu": (lambda x, a: F.leaky_relu(x, a), 0.2, math.sqrt(2)),
    "tanh": (lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": (lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": (lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": (lambda x, a: F.selu(x), 0.0, 1.0),
    "softplus": (lambda x, a: F.softplus(x), 0.0, 1.0),
    "swish": (lambda x, a: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """y = clamp(gain * act(x + b), -clamp, clamp), `b` broadcast on `dim`;
    the clamp applies only when `clamp` >= 0."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {act}")
    fn, def_alpha, def_gain = ACTIVATIONS[act]
    alpha = def_alpha if alpha is None else float(alpha)
    gain = def_gain if gain is None else float(gain)
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    x = fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = torch.clamp(x, -clamp, clamp)
    return x
