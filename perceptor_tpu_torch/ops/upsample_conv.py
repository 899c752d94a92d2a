"""Nearest-neighbour 2x upsampling (counterpart of
perceptor_tpu/ops/upsample_conv.py `nearest_upsample_2x`), NCHW.

`F.interpolate(x, scale_factor=2.0, mode="nearest")`, registered as the op
`perceptor_tpu_torch::nearest_upsample_2x` whose forward and backward call
the ATen kernels that `F.interpolate` and its autograd formula call
(`upsample_nearest2d` and `upsample_nearest2d_backward`), so the eager
results are `F.interpolate`'s bit for bit. As an op it stays one node of a
`torch.export` graph: traced through, `F.interpolate` would be decomposed
into an index and, backward, an accumulating index_put, whose CUDA atomics
sum in another order than the eager kernel, and an exported guided sampler
would not reproduce the eager one."""

from __future__ import annotations

from typing import List

import torch


def _sizes(x: torch.Tensor) -> List[int]:
    h, w = x.shape[-2:]
    return [2 * h, 2 * w]


@torch.library.custom_op("perceptor_tpu_torch::nearest_upsample_2x", mutates_args=())
def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    return torch.ops.aten.upsample_nearest2d.default(x, _sizes(x), 2.0, 2.0)


@nearest_upsample_2x.register_fake
def _(x):
    return x.new_empty((*x.shape[:-2], *_sizes(x)))


def _setup_context(ctx, inputs, output):
    ctx.input_size = list(inputs[0].shape)


def _backward(ctx, grad):
    h, w = ctx.input_size[-2:]
    return torch.ops.aten.upsample_nearest2d_backward.default(
        grad, [2 * h, 2 * w], ctx.input_size, 2.0, 2.0)


nearest_upsample_2x.register_autograd(_backward, setup_context=_setup_context)
