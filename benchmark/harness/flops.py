"""Model FLOPs and attention work of one call, counted as it runs.

A dispatch mode applies `torch.utils.flop_counter`'s formulas (those of
`FlopCounterMode`: the matrix products, convolutions and their input
gradients) to the aten ops as they execute, and bilinear upsampling as two
dense contractions, along W then H. An attention implementation's op,
named in `benchmark/attention_ops/`, is counted from its shapes alone:
`flops_per_bhqkd` b h s_q s_k d for q (b, h, s_q, d) and k (b, h, s_k, d),
the count its file gives (4 for a forward, 4 for each half of the input
gradient); its bytes are those of its tensor arguments read once and its
outputs written once. What such an op runs inside is not seen, so nothing
is counted twice. One multiply-add is 2 FLOPs.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


def _bilinear(n, c, h_in, w_in, h_out, w_out) -> int:
    return 2 * n * c * (h_in * w_out * w_in + h_out * w_out * h_in)


def _upsample(x, *args, out_val=None, **kwargs) -> int:
    return _bilinear(*x.shape, *out_val.shape[2:])


def _upsample_backward(grad_out, *args, out_val=None, **kwargs) -> int:
    return _bilinear(*out_val.shape, *grad_out.shape[2:])


FORMULAS = {
    **flop_registry,
    torch.ops.aten.upsample_bilinear2d: _upsample,
    torch.ops.aten.upsample_bilinear2d_backward: _upsample_backward,
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class FlopCount(TorchDispatchMode):
    """`flops`: the call's model FLOPs; `attention`: one (op, flops, bytes)
    per attention op called."""

    def __init__(self, attention_ops: dict):
        super().__init__()
        self.attention_ops = attention_ops
        self.flops = 0
        self.attention = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in self.attention_ops:
            q, k = args[0], args[1]
            b, h, sq, d = q.shape
            flops = self.attention_ops[name]["flops_per_bhqkd"] * b * h * sq * k.shape[2] * d
            self.attention.append((name, flops, _nbytes((args, kwargs)) + _nbytes(out)))
            self.flops += flops
        elif func._overloadpacket in FORMULAS:
            self.flops += FORMULAS[func._overloadpacket](*args, **kwargs, out_val=out)
        return out


def count(call, attention_ops: dict) -> FlopCount:
    """Run `call()` once under the counter; returns the counter."""
    with FlopCount(attention_ops) as counter:
        call()
    return counter
