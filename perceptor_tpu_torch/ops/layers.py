"""Layers with the JAX package's precision policy.

`Linear` and `Conv2d` are the counterparts of flax's `nn.Dense(dtype=...)`
and `nn.Conv(dtype=...)`: the input and the bias are cast to the weight's
dtype before the matmul, so a module whose weights are stored in bf16
(`core/dtypes.cast_matmul_params_bf16`) computes in bf16 while its fp32
biases and norms stay fp32 in storage. `GroupNorm` and `LayerNorm` compute
and return fp32 (flax norms with `dtype=float32`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.ops.groupnorm import group_norm


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        b = None if self.bias is None else self.bias.to(w.dtype)
        return F.linear(x.to(w.dtype), w, b)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        b = None if self.bias is None else self.bias.to(w.dtype)
        return self._conv_forward(x.to(w.dtype), w, b)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with min(32, C) groups, fp32 statistics and fp32 output."""

    def __init__(self, channels: int, eps: float):
        super().__init__(min(32, channels), channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        )
