"""GPipe-style pipeline parallelism over the `stage` mesh axis (counterpart
of perceptor_tpu/parallel/pipeline.py).

A deep network is split into N stages of the same activation shape, one per
rank of the `stage` axis, and M microbatches stream through: each tick,
stage 0 takes the next microbatch, every rank applies its stage to its
current activation, the last stage banks its finished microbatch, and the
activations move one rank down the chain (stage i -> i + 1, no wraparound:
`collectives.shift(wrap=False)`, whose backward sends the gradients back up).
The banked outputs reach every rank through an all-reduce. `stage_params`
carries the per-stage weights stacked on a leading axis that is split over
`stage`, so each rank holds its own stage's weights. Autograd differentiates
the whole schedule.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_map

from perceptor_tpu_torch.parallel import collectives
from perceptor_tpu_torch.parallel.mesh import AXIS_STAGE, axis_size


def pipeline_body(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    axis_name=AXIS_STAGE,
) -> torch.Tensor:
    """Per-rank pipeline schedule: `stage_params` is this rank's stage
    weights, `microbatches` the full (M, ...) stack, the same on every rank;
    `axis_name` a ProcessGroup or a (DeviceMesh, dim name) pair. Returns the
    (M, ...) outputs on every rank."""
    n = collectives.group_size(axis_name)
    idx = collectives.group_rank(axis_name)
    m = microbatches.shape[0]
    ticks = m + n - 1
    first = torch.tensor(idx == 0, device=microbatches.device)
    state = torch.zeros_like(microbatches[0])
    banked = []
    for t in range(ticks):
        # JAX's where: every rank's received state stays in the graph, so
        # every rank runs each shift's backward
        x_in = torch.where(first, microbatches[min(t, m - 1)], state)
        y = stage_fn(stage_params, x_in)
        if t >= n - 1:
            banked.append(y)
        if t < ticks - 1:  # the last tick's activations go nowhere
            state = collectives.shift(y, axis_name, wrap=False) if n > 1 else y
    outputs = torch.stack(banked)
    # the result lives on the last stage; the others add zeros that keep
    # their graphs joined, as JAX's where does
    outputs = outputs if idx == n - 1 else outputs * 0
    return collectives.psum(outputs, axis_name)


def pipeline(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh,
    n_microbatches: int,
    stage_axis: str = AXIS_STAGE,
) -> torch.Tensor:
    """Run x (batch leading; the same on every rank, or a DTensor) through
    N pipelined stages of `stage_fn(params_i, h) -> h'`, which must keep the
    activation shape. `stage_params` leaves (tensors the same on every rank,
    or DTensors) have a leading N-stages axis, split over the stage axis.
    The batch must divide by n_microbatches. Returns the output on every
    rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    n_stages = axis_size(mesh, stage_axis)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} microbatches")
    for leaf in torch.utils._pytree.tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(f"stage_params leading dim {leaf.shape[0]} != {n_stages} stages")
    group = (mesh, stage_axis)
    placements = [Shard(0) if name == stage_axis else Replicate()
                  for name in mesh.mesh_dim_names]

    def local(leaf):  # this rank's (1, ...) slot; the gradient is all-gathered back
        if not isinstance(leaf, DTensor):
            leaf = DTensor.from_local(leaf, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return leaf.redistribute(mesh, placements).to_local()[0]

    params = tree_map(local, stage_params)
    mb = collectives.replicated(x, group).reshape(
        n_microbatches, batch // n_microbatches, *x.shape[1:])
    out = pipeline_body(stage_fn, params, mb, axis_name=group)
    return out.reshape(batch, *x.shape[1:])
