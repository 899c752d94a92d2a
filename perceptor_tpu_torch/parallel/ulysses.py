"""Ulysses sequence parallelism: all-to-all head-sharded attention
(counterpart of perceptor_tpu/parallel/ulysses.py).

One all-to-all re-shards (B, H, S/n, D) activations from sequence-sharded
to head-sharded (B, H/n, S, D), each rank runs ordinary attention over its
head group with the whole sequence local, and a second all-to-all restores
the sequence sharding. Works for self- and cross-attention (q and k/v
lengths may differ); needs heads % n == 0. The all-to-alls are
`collectives.all_to_all`, whose backward is the transposed all-to-all.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from perceptor_tpu_torch.ops.attention import dot_product_attention
from perceptor_tpu_torch.parallel import collectives
from perceptor_tpu_torch.parallel.mesh import AXIS_CONTEXT, AXIS_DATA, axis_size


def ulysses_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Per-rank Ulysses body over local (B, H, S_local, D) shards, the
    sequence sharded over `axis_name` (a ProcessGroup or a (DeviceMesh, dim
    name) pair); H must divide by the group size. `kv_len`: the number of
    real keys; positions past it (divisibility padding) are masked out of
    the softmax."""
    n = collectives.group_size(axis_name)
    heads = q.shape[1]
    if heads % n:
        raise ValueError(f"{heads} heads not divisible by axis size {n}")

    def to_head_sharded(x):  # (B, H, S/n, D) -> (B, H/n, S, D)
        return collectives.all_to_all(x, axis_name, split_axis=1, concat_axis=2)

    def to_seq_sharded(x):
        return collectives.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    k_full = to_head_sharded(k)
    mask = None
    if kv_len is not None and kv_len < k_full.shape[2]:
        key_pos = torch.arange(k_full.shape[2], device=k.device)
        mask = torch.where(key_pos < kv_len, 0.0, -1e10)[None, None, None, :]
    out = dot_product_attention(
        to_head_sharded(q), k_full, to_head_sharded(v), mask=mask, scale=scale)
    return to_seq_sharded(out)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    scale: Optional[float] = None,
    context_axis: str = AXIS_CONTEXT,
    batch_axis: Optional[str] = AXIS_DATA,
) -> torch.Tensor:
    """Head-sharded sequence-parallel attention over (B, H, S, D): global
    tensors (the same on every rank) or DTensors, on a DeviceMesh. The head
    count must divide by the context axis size; sequence lengths need not:
    q and k/v are zero-padded to the next multiple, padded keys are masked
    out of the softmax and padded query rows sliced off. Returns a DTensor
    for DTensor inputs (gathered, since the padding changes the sharded
    length), else the global tensor on every rank."""
    from torch.distributed.tensor import DTensor

    n = axis_size(mesh, context_axis)
    as_dtensor = any(isinstance(t, DTensor) for t in (q, k, v))
    if as_dtensor:
        q, k, v = (t.full_tensor() if isinstance(t, DTensor) else t for t in (q, k, v))

    def pad_seq(x):
        pad = (-x.shape[2]) % n
        return F.pad(x, (0, 0, 0, pad)) if pad else x

    q_len, kv_len = q.shape[2], k.shape[2]
    group = (mesh, context_axis)

    def body(ql, kl, vl):
        return ulysses_self_attention(ql, kl, vl, group, scale=scale, kv_len=kv_len)

    placements = collectives.seq_placements(mesh, context_axis, batch_axis, q.shape[0])
    out = collectives.shard_map(body, mesh, (pad_seq(q), pad_seq(k), pad_seq(v)), placements)
    out = out[:, :, :q_len] if out.shape[2] != q_len else out
    if as_dtensor:
        from torch.distributed.tensor import Replicate

        return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out
