"""The autograd-aware collectives under ring, Ulysses and the pipeline.

Each is one functional collective (`torch.distributed._functional_collectives`),
so a traced program shows it as a `_c10d_functional` node that
`utils.hlo` can count, and its backward is the transposed collective:

  - `shift`: every rank sends its tensor to rank + offset of the group and
    receives rank - offset's (JAX `ppermute` over a ring, or over a chain
    with `wrap=False`, where the first ranks receive zeros). It is an
    `all_to_all_single` whose splits are one-hot; its backward is the
    inverse shift.
  - `all_to_all`: split dim `split_axis` into group-size chunks, send
    chunk j to rank j and concatenate what arrives on `concat_axis` (JAX
    `all_to_all(tiled=True)`).
  - `psum`: the sum over the group (JAX `psum`); its backward is the
    identity, as the gradient arrives replicated.

`group` is a ProcessGroup, or a (DeviceMesh, dim name) pair: the
counterpart of a JAX axis name inside `shard_map`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def resolve_group(group):
    """A ProcessGroup from a ProcessGroup or a (DeviceMesh, dim name) pair."""
    if isinstance(group, tuple):
        mesh, name = group
        return mesh.get_group(name)
    return group


def group_size(group) -> int:
    return dist.get_world_size(resolve_group(group))


def group_rank(group) -> int:
    return dist.get_rank(resolve_group(group))


def shift(x: torch.Tensor, group, offset: int = 1, wrap: bool = True) -> torch.Tensor:
    """x of rank r arrives at rank r + offset (mod n with `wrap`; past the
    last rank it is dropped and the first ranks get zeros without it)."""
    group = resolve_group(group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x if wrap else torch.zeros_like(x)
    numel = x.numel()
    dst, src = r + offset, r - offset
    sends = wrap or 0 <= dst < n
    send = [0] * n
    recv = [0] * n
    if sends:
        send[dst % n] = numel
    if wrap or 0 <= src < n:
        recv[src % n] = numel
    flat = x.reshape(-1)
    out = funcol.all_to_all_single_autograd(
        (flat if sends else flat[:0]).contiguous(), recv, send, group)
    if out.numel() == 0:
        # nothing arrives: zeros, joined to the graph so that every rank
        # runs this collective's backward
        return torch.zeros_like(x) + out.sum()
    return out.reshape(x.shape)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX `all_to_all(x, axis, split_axis, concat_axis, tiled=True)`."""
    group = resolve_group(group)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[split_axis] //= n
    parts = x.reshape(*x.shape[:split_axis], n, shape[split_axis], *x.shape[split_axis + 1:])
    parts = parts.movedim(split_axis, 0).contiguous()  # chunk j goes to rank j
    got = funcol.all_to_all_single_autograd(parts, None, None, group)  # chunk i from rank i
    shape[concat_axis] *= n
    return got.movedim(0, concat_axis).reshape(shape)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient passes through as it arrives."""
    group = resolve_group(group)
    if dist.get_world_size(group) == 1:
        return x
    return _PSum.apply(x, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def seq_placements(mesh, context_axis: str, batch_axis, batch: int):
    """DTensor placements of a (B, H, S, D) attention operand: S over the
    context axis, B over the batch axis when the mesh has it and it divides
    (else replicated, as JAX's `ring_attention` does), replicated over every
    other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    from perceptor_tpu_torch.parallel.mesh import axis_size

    names = mesh.mesh_dim_names
    if batch_axis is not None and (batch_axis not in names
                                   or batch % axis_size(mesh, batch_axis)):
        batch_axis = None
    return [Shard(2) if name == context_axis else Shard(0) if name == batch_axis
            else Replicate() for name in names]


def shard_map(body, mesh, tensors, placements):
    """`body` over each rank's local shards of `tensors` placed by
    `placements`, the counterpart of JAX `shard_map` with equal in and out
    specs. DTensors are redistributed to the placements; plain tensors are
    taken as the global value, the same on every rank. The result is a
    DTensor with the same placements when any input was one, else the global
    tensor on every rank. Every step is differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    from perceptor_tpu_torch.parallel import strategies

    strategies.register()
    as_dtensor = any(isinstance(t, DTensor) for t in tensors)
    local = []
    for t in tensors:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        local.append(t.redistribute(mesh, placements).to_local())
    out = DTensor.from_local(body(*local), mesh, placements, run_check=False)
    return out if as_dtensor else out.full_tensor()


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """x, the same on every rank of the group, as an input whose gradient
    is summed over the group (JAX's transpose of a replicated `shard_map`
    input): each rank's use of it adds to the one gradient."""
    group = resolve_group(group)
    if dist.get_world_size(group) == 1:
        return x
    return _Replicated.apply(x, group)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return funcol.wait_tensor(funcol.all_reduce(grad.contiguous(), "sum", ctx.group)), None
