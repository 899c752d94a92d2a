"""Multi-head attention (counterpart of perceptor_tpu/ops/attention.py).

Two paths over (batch, heads, seq, head_dim) tensors:

  - `dot_product_attention`: q k^T -> fp32 softmax -> p v in PyTorch.
  - `flash_attention` (ops/flash_attention_kernel.py): the hand-written
    CUDA kernels, which never write the (S, S) scores to device memory.

`attention` routes long unmasked self-attention on a CUDA device to the
kernels (the JAX rule of `flash_route`) and everything else to the
dot-product path; under `model_flops_trace` every call takes the
dot-product path. Under an active context-parallel plan
(parallel/plan.py), long self-attention runs as ring attention and
cross-attention as Ulysses attention over the plan's context axis. Every
decision goes to the active `parallel.record_routing()` report with its
reason, under JAX's route names: "ring", "ulysses", "flash", and "xla" for
the dot-product path.
"""

from __future__ import annotations

import contextlib
import math
import sys
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


_PLAN_MODULE = "perceptor_tpu_torch.parallel.plan"


def _context_plan_route_explain(seq_q: int, seq_k: int, heads: int, masked: bool):
    """(plan, route, reason) under the active context-parallel plan, or
    (None, None, None). No plan can be active before parallel/plan.py is
    imported, so the module is looked up, not imported."""
    plan_module = sys.modules.get(_PLAN_MODULE)
    plan = plan_module.current_plan() if plan_module is not None else None
    if plan is None:
        return None, None, None
    route, reason = plan.route_explain(seq_q, seq_k, heads, masked=masked)
    return plan, route, reason


def _record_route(shape, route, reason) -> None:
    plan_module = sys.modules.get(_PLAN_MODULE)
    if plan_module is not None:
        plan_module.record_route("attention", shape, route, reason)


def flash_route(seq_q: int, seq_k: int, masked: bool = False,
                q: Optional[torch.Tensor] = None) -> bool:
    """True when `attention` takes the flash kernels: unmasked, S_q == S_k
    >= 1024 and a multiple of 128 (the JAX rule), on a CUDA device: `q`'s,
    or with no `q` whether CUDA is available. False under
    `model_flops_trace`, and False where an active context-parallel plan
    routes the shape to the ring or Ulysses (as in JAX, heads=1 decides:
    any flash-eligible length is ring-eligible). The rule looks at no
    head_dim or dtype: `flash_attention` pads a head_dim to a multiple of 8,
    and what the kernels still cannot run (a head_dim above 512, fp16)
    raises there; nothing is sent to the dot-product path on that account."""
    on_cuda = torch.cuda.is_available() if q is None else q.is_cuda
    if _context_plan_route_explain(seq_q, seq_k, 1, masked)[1] is not None:
        return False
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
    `flash_route`, True/False force the route. Under a context-parallel plan
    that routes the shape, the ring or Ulysses runs over the plan's context
    axis alone: the port's mesh samplers hand each data rank its own batch
    shard, so q, k and v are the same on the context ranks and the result
    is gathered back to them."""
    seq_q, seq_k = q.shape[-2], k.shape[-2]
    site_shape = (seq_q, seq_k, q.shape[1])
    plan, plan_route, plan_reason = _context_plan_route_explain(
        seq_q, seq_k, q.shape[1], mask is not None)
    if plan_route is not None:
        from perceptor_tpu_torch.parallel.plan import RING
        from perceptor_tpu_torch.parallel.ring_attention import ring_attention
        from perceptor_tpu_torch.parallel.ulysses import ulysses_attention

        _record_route(site_shape, plan_route, plan_reason)
        route_fn = ring_attention if plan_route == RING else ulysses_attention
        return route_fn(q, k, v, plan.mesh[plan.context_axis], scale=scale,
                        context_axis=plan.context_axis, batch_axis=None)
    fallback = f"; plan fallback: {plan_reason}" if plan is not None else ""
    if use_flash is None:
        use_flash = flash_route(seq_q, seq_k, mask is not None, q)
    if use_flash and not _COUNTING_MODEL_FLOPS:
        if mask is not None:
            raise ValueError("the flash kernels take no mask")
        _record_route(site_shape, "flash",
                      "flash kernels (long unmasked self-attention on CUDA)" + fallback)
        return flash_attention(q, k, v, scale=scale)
    _record_route(site_shape, "xla", "XLA dot-product attention" + fallback)
    return dot_product_attention(q, k, v, mask=mask, scale=scale)
