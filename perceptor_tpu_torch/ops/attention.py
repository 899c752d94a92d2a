"""Multi-head attention (counterpart of perceptor_tpu/ops/attention.py).

Two paths over (batch, heads, seq, head_dim) tensors:

  - `dot_product_attention`: q k^T -> fp32 softmax -> p v in PyTorch.
  - `flash_attention` (ops/flash_attention_kernel.py): the hand-written
    CUDA kernels, which never write the (S, S) scores to device memory.

`attention` routes long unmasked self-attention on a CUDA device to the
kernels (the JAX rule of `flash_route`) and everything else to the
dot-product path; under `model_flops_trace` every call takes the
dot-product path. The context-parallel plans of the JAX package are not
ported.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from perceptor_tpu_torch.ops.flash_attention_kernel import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v; the softmax runs in fp32 whatever the
    input dtype, the products in the input dtype. `mask` is additive,
    broadcast to (B, H, Sq, Sk)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def causal_mask(seq_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask, (1, 1, S, S)."""
    mask = torch.triu(torch.full((seq_len, seq_len), -1e10, dtype=dtype, device=device), 1)
    return mask[None, None]


# Model-FLOPs counting mode (JAX `model_flops_trace`): the counter of
# utils/flops.py sees aten products only, not the kernels' ctypes launches,
# so counting sends every attention to the dot-product path, whose q k^T
# and p v products it counts at the true head_dim.
_COUNTING_MODEL_FLOPS = False


@contextlib.contextmanager
def model_flops_trace():
    """Route every attention, a forced one too, through
    `dot_product_attention` inside the block."""
    global _COUNTING_MODEL_FLOPS
    prior = _COUNTING_MODEL_FLOPS
    _COUNTING_MODEL_FLOPS = True
    try:
        yield
    finally:
        _COUNTING_MODEL_FLOPS = prior


def flash_route(seq_q: int, seq_k: int, masked: bool = False,
                q: Optional[torch.Tensor] = None) -> bool:
    """True when `attention` takes the flash kernels: unmasked, S_q == S_k
    >= 1024 and a multiple of 128 (the JAX rule), on a CUDA device: `q`'s,
    or with no `q` whether CUDA is available. False under
    `model_flops_trace`. The rule looks at no head_dim or dtype:
    `flash_attention` pads a head_dim to a multiple of 8, and what the
    kernels still cannot run (a head_dim above 512, fp16) raises there;
    nothing is sent to the dot-product path on that account."""
    on_cuda = torch.cuda.is_available() if q is None else q.is_cuda
    return (
        not _COUNTING_MODEL_FLOPS
        and not masked
        and seq_q >= 1024
        and seq_q == seq_k
        and seq_q % 128 == 0
        and on_cuda
    )


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Dispatching attention entry point; `use_flash=None` applies
    `flash_route`, True/False force the route."""
    if use_flash is None:
        use_flash = flash_route(q.shape[-2], k.shape[-2], mask is not None, q)
    if use_flash and not _COUNTING_MODEL_FLOPS:
        if mask is not None:
            raise ValueError("the flash kernels take no mask")
        return flash_attention(q, k, v, scale=scale)
    return dot_product_attention(q, k, v, mask=mask, scale=scale)
