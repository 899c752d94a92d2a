"""Residual add + LayerNorm that writes the bf16 operand of the products
after it: `add_layer_norm(x, h, weight, bias, eps) -> (r, y)`, with
r = x + h in bf16 (x itself where h is None) and y the LayerNorm of r over
its last axis, fp32 statistics and affine, rounded once to bf16. The SD
UNet's `BasicTransformerBlock` calls it for its three norms when it runs
in bf16 with no gradient.

The computation is the op `perceptor_tpu_torch::add_layer_norm`: on a CUDA
tensor it launches the hand-written kernel of `csrc/layernorm.cu` (one
launch a call, counted in `LN_LAUNCHES`) or raises; on a CPU tensor it is
the plain version (`add_layer_norm_plain`), the chain the block ran
before: the bf16 add, `.float()`, fp32 `F.layer_norm` and the cast to
bf16; a fake implementation gives tracing the shapes, so an exported
program holds it as one node. The port's span `layer_norm` (`rows`)
covers each call.

The kernel replaces no TPU kernel: JAX leaves LayerNorm to XLA, which
fuses it with the add and the cast. It replaces a chain of 13 launches and
about 90 bytes per residual element in a block; it is bound by bytes at
3.35 TB/s, 8 bytes per element with h (x, h read; r, y written) and 4
without (x read, y written).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from perceptor_tpu_torch.ops import cuda_library
from perceptor_tpu_torch.utils import profiling

VEC = 8  # bf16 channels in one 16-byte vector: C is a multiple of it
MAX_CHANNELS = 2048  # 8 vectors a lane of a warp

# kernel launches, reset by callers that need to prove a path went through
# the kernel: calls without a branch to add, and with one
LN_LAUNCHES = {"layer_norm": 0, "add_layer_norm": 0}


def reset_launches() -> None:
    for name in LN_LAUNCHES:
        LN_LAUNCHES[name] = 0


def takes_channels(c: int) -> bool:
    """Whether the kernel takes rows of `c` channels."""
    return c % VEC == 0 and VEC <= c <= MAX_CHANNELS


def check_args(x_shape, x_dtype, h_shape, h_dtype, weight_shape, bias_shape) -> None:
    """Raises on what the kernel does not take: x (..., C) bfloat16 with C a
    multiple of VEC up to MAX_CHANNELS, h None or of x's shape and dtype,
    weight and bias (C,)."""
    if x_dtype != torch.bfloat16:
        raise TypeError(f"x: the kernel takes bfloat16, got {x_dtype}")
    if len(x_shape) < 1 or not takes_channels(x_shape[-1]):
        raise ValueError(f"x has shape {tuple(x_shape)}: the kernel takes a last axis of a "
                         f"multiple of {VEC} channels up to {MAX_CHANNELS}")
    c = x_shape[-1]
    rows = 1
    for n in x_shape[:-1]:
        rows *= n
    if not 1 <= rows < 2**31:
        raise ValueError(f"x has shape {tuple(x_shape)}: the kernel takes 1 to 2**31 - 1 rows")
    if h_shape is not None and (tuple(h_shape) != tuple(x_shape) or h_dtype != x_dtype):
        raise ValueError(f"h is {h_dtype} of shape {tuple(h_shape)}, x {x_dtype} of shape "
                         f"{tuple(x_shape)}")
    for name, shape in (("weight", weight_shape), ("bias", bias_shape)):
        if tuple(shape) != (c,):
            raise ValueError(f"{name} has shape {tuple(shape)}, want {(c,)}")


def add_layer_norm_plain(x, h, weight, bias, eps: float):
    """(r, y): r = x + h (x where h is None), y = F.layer_norm of r in fp32
    with fp32 weight and bias, cast to bf16."""
    r = x if h is None else x + h
    y = F.layer_norm(r.float(), (r.shape[-1],), weight.float(), bias.float(), eps)
    return r, y.to(torch.bfloat16)


_P = ctypes.c_void_p
_ARGTYPES = {
    # x, h, weight, bias, r, y | rows, C | eps | stream
    "add_layer_norm": [_P] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, _P],
}
cuda_library.declare(_ARGTYPES)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address, copied only if not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# -- the registered op -------------------------------------------------------
#
# The CUDA implementation launches the kernel and counts it, the CPU
# implementation is the plain version, the fake implementation gives the
# shapes to tracing; each checks its arguments first. An op's output may
# not alias its input, so without h the op's r is empty and
# `add_layer_norm` hands back x in its place.


def _check(x, h, weight, bias) -> None:
    check_args(x.shape, x.dtype, None if h is None else h.shape, None if h is None else h.dtype,
               weight.shape, bias.shape)


@torch.library.custom_op("perceptor_tpu_torch::add_layer_norm", mutates_args=(),
                         device_types="cpu")
def _ln_op(x: torch.Tensor, h: Optional[torch.Tensor], weight: torch.Tensor,
           bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, h, weight, bias)
    r, y = add_layer_norm_plain(x, h, weight, bias, eps)
    return (x.new_empty(0) if h is None else r), y


@_ln_op.register_kernel("cuda")
def _ln_cuda(x, h, weight, bias, eps):
    _check(x, h, weight, bias)
    for name, t in (("h", h), ("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    c = x.shape[-1]
    x = _aligned(x)
    weight, bias = _aligned(weight.float()), _aligned(bias.float())
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if h is None:
        r = x.new_empty(0)
        h_ptr = r_ptr = None
    else:
        h = _aligned(h)
        r = torch.empty_like(y)
        h_ptr, r_ptr = h.data_ptr(), r.data_ptr()
    cuda_library.launch("add_layer_norm", x.device, x.data_ptr(), h_ptr, weight.data_ptr(),
                        bias.data_ptr(), r_ptr, y.data_ptr(), x.numel() // c, c, float(eps))
    LN_LAUNCHES["layer_norm" if h is None else "add_layer_norm"] += 1
    return r, y


@_ln_op.register_fake
def _(x, h, weight, bias, eps):
    _check(x, h, weight, bias)
    y = x.new_empty(x.shape, dtype=torch.bfloat16)
    return (x.new_empty(0) if h is None else torch.empty_like(y)), y


def add_layer_norm(x: torch.Tensor, h: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r, y): r = x + h in bf16 (x itself where h is None), y the LayerNorm
    of r over the last axis in bf16 (fp32 statistics and affine, one
    rounding). x and h bfloat16 (..., C), C a multiple of VEC up to
    MAX_CHANNELS; weight and bias (C,). The kernel on a CUDA tensor, the
    plain version on a CPU tensor; the port's span `layer_norm` covers the
    call."""
    with profiling.annotate("layer_norm", rows=x.shape[0]):
        r, y = _ln_op(x, h, weight, bias, float(eps))
    return (x if h is None else r), y
