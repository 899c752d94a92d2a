"""Model FLOP counting (counterpart of perceptor_tpu/utils/flops.py).

The JAX package walks a traced jaxpr and counts `2 * prod(out) * K` for
every dot_general and conv_general_dilated. Here the call runs under a
dispatch mode that applies `torch.utils.flop_counter`'s formulas (those of
`FlopCounterMode`) to the aten products as they execute: mm, addmm, bmm,
baddbmm, the convolutions and their backward (a frozen weight's gradient is
not computed, so not counted), and bilinear upsampling, which the JAX
package computes as two dense contractions (`jax.image.resize`: along W,
then along H) and the counter counts as such. `FlopCounterMode` itself
also tracks modules
with backward hooks, which `torch.autograd.grad` on a leaf input refuses,
and the guided steps differentiate exactly so. One multiply-add is 2 FLOPs;
a forward-only call counts its forward, a call that differentiates counts
both passes.

The flash kernels are ctypes launches that no counter sees. For the MFU
numerator `count_model_flops` runs the call under
`ops.attention.model_flops_trace`, which sends every attention to the
dot-product path, so the q k^T and p v products are counted at the true
head_dim (4 b h s^2 d forward, 8 b h s^2 d for the input gradient): the
model's FLOPs, not the kernels' (the flash backward recomputes the scores).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from perceptor_tpu_torch.ops.attention import model_flops_trace


def card_peaks(name: str):
    """(dense bf16 FLOP/s, memory bytes/s) of the card named `name`, from
    NVIDIA's data sheets; the H100 SXM's unless the name says otherwise."""
    upper = name.upper()
    if "H100" in upper and "PCIE" in upper:
        return 756e12, 2.0e12
    if "H100" in upper and "NVL" in upper:
        return 835e12, 3.9e12
    if "H200" in upper:
        return 989e12, 4.8e12
    return 989e12, 3.35e12  # H100 SXM


def _bilinear_flops(n: int, c: int, h_in: int, w_in: int, h_out: int, w_out: int) -> int:
    """jax.image.resize's "linear" contractions as the JAX counter counts
    them: (H_in, W_in) -> (H_in, W_out) -> (H_out, W_out), each a dense
    matrix product."""
    return 2 * n * c * (h_in * w_out * w_in + h_out * w_out * h_in)


def _upsample_flops(x, *args, out_val=None, **kwargs) -> int:
    return _bilinear_flops(*x.shape, *out_val.shape[2:])


def _upsample_backward_flops(grad_out, *args, out_val=None, **kwargs) -> int:
    """The gradient of the two contractions with respect to their input:
    the same products, transposed."""
    return _bilinear_flops(*out_val.shape, *grad_out.shape[2:])


_FORMULAS = {
    **flop_registry,
    torch.ops.aten.upsample_bilinear2d: _upsample_flops,
    torch.ops.aten.upsample_bilinear2d_backward: _upsample_backward_flops,
}


class _Tally(TorchDispatchMode):
    """FlopCounterMode's per-op formulas (and the bilinear upsampling's),
    tallied by op and operand shapes."""

    def __init__(self):
        super().__init__()
        self.tally: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _FORMULAS:
            flops = _FORMULAS[packet](*args, **kwargs, out_val=out)
            if flops:
                shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
                bucket = self.tally.setdefault(f"{packet.__name__} {shapes}", [0, 0])
                bucket[0] += flops
                bucket[1] += 1
        return out


def count_flops_by_op(fn, *args, **kwargs) -> dict:
    """Per-op FLOP breakdown of one call: {label: (flops, count)}, the label
    the aten op and its operands' shapes. Diffing two breakdowns shows which
    products moved a total."""
    with _Tally() as mode:
        fn(*args, **kwargs)
    return {label: tuple(v) for label, v in mode.tally.items()}


def count_flops(fn, *args, **kwargs) -> int:
    """Matmul/conv FLOPs of one call of `fn(*args, **kwargs)`, as it runs:
    the flash kernels' launches are not counted (`count_model_flops`
    counts the attention they stand for)."""
    return sum(flops for flops, _ in count_flops_by_op(fn, *args, **kwargs).values())


def count_model_flops(fn, *args, **kwargs) -> int:
    """Model (mathematical) matmul/conv FLOPs of one call, the MFU
    numerator: `count_flops` with every attention on the dot-product path.
    The call runs, at that route's cost in time and memory."""
    with model_flops_trace():
        return count_flops(fn, *args, **kwargs)


def mfu(flops: int, seconds: float, peak: Optional[float] = None) -> float:
    """Model FLOP utilization: `flops` in `seconds` over `peak` FLOP/s, by
    default the dense bf16 peak of CUDA device 0 (`card_peaks`)."""
    if not math.isfinite(seconds) or seconds <= 0:
        raise ValueError("seconds must be positive")
    if peak is None:
        peak = card_peaks(torch.cuda.get_device_name(0))[0]
    return flops / seconds / peak
