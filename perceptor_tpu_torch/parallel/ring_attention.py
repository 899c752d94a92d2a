"""Ring attention: context-parallel attention over the `context` mesh axis
(counterpart of perceptor_tpu/parallel/ring_attention.py).

The token axis is sharded over the context ranks; K/V blocks rotate one rank
per step around the ring (`collectives.shift`, an autograd-aware functional
collective whose backward is the inverse rotation, as JAX's `ppermute`
transposes), and the partial softmax results combine by the online-softmax
(m, l, acc) recurrence in fp32, JAX's recurrence line for line. Each rank
holds S/n queries and sees S/n keys per step, so no (S, S) score matrix
exists anywhere. Plain PyTorch, differentiable by autograd.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from perceptor_tpu_torch.parallel import collectives
from perceptor_tpu_torch.parallel.mesh import AXIS_CONTEXT, AXIS_DATA, axis_size

NEG_INF = -1e30


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name,
    scale: Optional[float] = None,
    unroll: bool = True,
) -> torch.Tensor:
    """Per-rank ring attention body over local (B, H, S/n, D) shards, the
    sequence sharded over `axis_name` (a ProcessGroup or a (DeviceMesh, dim
    name) pair). Statistics are fp32 whatever the input dtype. `unroll` is
    JAX's scan option; the eager loop here always runs unrolled."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = collectives.group_size(axis_name)
    q32 = q.float()
    m = torch.full_like(q32[..., 0], NEG_INF)
    l = torch.zeros_like(q32[..., 0])
    acc = torch.zeros_like(q32)
    k_blk, v_blk = k, v
    for step in range(n):
        s = torch.einsum("bhqd,bhkd->bhqk", q32, k_blk.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk.float())
        m = m_new
        if step < n - 1:  # the n-th rotation would only bring the blocks home
            k_blk = collectives.shift(k_blk, axis_name)
            v_blk = collectives.shift(v_blk, axis_name)
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    scale: Optional[float] = None,
    context_axis: str = AXIS_CONTEXT,
    batch_axis: Optional[str] = AXIS_DATA,
    unroll: bool = True,
) -> torch.Tensor:
    """Context-parallel attention over (B, H, S, D): global tensors (the
    same on every rank) or DTensors, on a DeviceMesh. S is sharded over
    `context_axis` (and B over `batch_axis` when the mesh has it and it
    divides), the ring runs on each rank's shards, and the result is a
    DTensor with those placements, or for plain inputs the global tensor on
    every rank. S must divide by the context axis size."""
    n_ctx = axis_size(mesh, context_axis)
    if q.shape[2] % n_ctx or k.shape[2] % n_ctx:
        raise ValueError(
            f"sequence length {q.shape[2]} must divide context axis size {n_ctx}")
    group = (mesh, context_axis)

    def body(ql, kl, vl):
        return ring_self_attention(ql, kl, vl, group, scale=scale, unroll=unroll)

    placements = collectives.seq_placements(mesh, context_axis, batch_axis, q.shape[0])
    return collectives.shard_map(body, mesh, (q, k, v), placements)
