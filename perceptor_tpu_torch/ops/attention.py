"""Multi-head attention (counterpart of perceptor_tpu/ops/attention.py).

Two paths over (batch, heads, seq, head_dim) tensors:

  - `dot_product_attention`: q k^T -> fp32 softmax -> p v in PyTorch.
  - `flash_attention` (ops/flash_attention_kernel.py): the hand-written
    CUDA kernels, which never write the (S, S) scores to device memory.

`attention` routes long unmasked self-attention on a CUDA device to the
kernels (the JAX rule of `flash_route`) and everything else to the
dot-product path. The context-parallel plans of the JAX package are not
ported.
"""

from __future__ import annotations

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


def flash_route(seq_q: int, seq_k: int, masked: bool, q: torch.Tensor) -> bool:
    """True when `attention` takes the flash kernels: unmasked, S_q == S_k
    >= 1024 and a multiple of 128 (the JAX rule), for a tensor on a CUDA
    device."""
    return (
        not masked
        and seq_q >= 1024
        and seq_q == seq_k
        and seq_q % 128 == 0
        and q.is_cuda
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
    if use_flash:
        if mask is not None:
            raise ValueError("the flash kernels take no mask")
        return flash_attention(q, k, v, scale=scale)
    return dot_product_attention(q, k, v, mask=mask, scale=scale)
