"""Layers with the JAX package's precision policy.

`Linear` and `Conv2d` are the counterparts of flax's `nn.Dense(dtype=...)`
and `nn.Conv(dtype=...)`: the input and the bias are cast to the weight's
dtype before the matmul, so a module whose weights are stored in bf16
(`core/dtypes.cast_matmul_params_bf16`) computes in bf16 while its fp32
biases and norms stay fp32 in storage. `GroupNorm` and `LayerNorm` compute
and return fp32 (flax norms with `dtype=float32`), and so does
`FrozenBatchNorm2d`, the inference-mode BatchNorm of the CLIP ResNets.
`pad_same` and `Conv2dSame` give TensorFlow's "SAME" padding, which is
asymmetric where a stride meets an even size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.ops.groupnorm import group_norm_fp32


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


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        b = None if self.bias is None else self.bias.to(w.dtype)
        return F.conv_transpose2d(x.to(w.dtype), w, b, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing two dims as TensorFlow's "SAME" (lax / flax
    `padding="SAME"`): `total // 2` before and the rest after, so a stride
    on an even size pads one more pixel after than before (7x7/2 on 384:
    2 and 3), where PyTorch's symmetric `padding=` is a pixel off. `value`
    is -inf for a max pool."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad lists the last dim first
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class Conv2dSame(Conv2d):
    """`Conv2d` with "SAME" padding for a square kernel and stride
    (gen-efficientnet's `Conv2dSame`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, groups=groups,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(pad_same(x, self.kernel_size[0], self.stride[0]))


class GroupNorm(nn.GroupNorm):
    """GroupNorm with min(num_groups, C) groups, fp32 statistics and fp32
    output."""

    def __init__(self, channels: int, eps: float, num_groups: int = 32):
        super().__init__(min(num_groups, channels), channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_fp32(x, self.weight, self.bias, self.num_groups, self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        )


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm over NCHW with torch.nn.BatchNorm2d's names
    (`weight`, `bias` and the `running_mean` / `running_var` buffers),
    computed and returned in fp32. A checkpoint's `num_batches_tracked`
    is dropped on load."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_buffers(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        return x.float() * inv[:, None, None] + shift[:, None, None]
