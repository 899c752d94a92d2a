"""DTensor sharding strategies for the port's registered ops.

DTensor needs a strategy for every op it meets. The flash forward, dq and
dk/dv ops (`perceptor_tpu_torch::flash_fwd`, `::flash_dq`, `::flash_dkv`,
ops/flash_attention_kernel.py) and `::nearest_upsample_2x`
(ops/upsample_conv.py) compute each batch element and head on its own, so
their operands may be sharded on the batch dim (0) or the head/channel dim
(1), all alike, and each rank computes on its local shards; or replicated.
`register()` runs once, when the port first makes a mesh or places a
tensor on one (`create_mesh`, `create_hybrid_mesh`, `partition.placements`,
`collectives.shard_map`), so that importing the package does not import
DTensor.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def register() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    import perceptor_tpu_torch.ops.flash_attention_kernel  # noqa: F401  (registers the ops)
    import perceptor_tpu_torch.ops.upsample_conv  # noqa: F401

    ops = torch.ops.perceptor_tpu_torch

    def alike(n_out: int, n_tensors: int, n_scalars: int):
        """(outputs, inputs) placements: all Shard(0), all Shard(1), or all
        Replicate; None for the trailing non-tensor arguments."""
        return [([p] * n_out, [p] * n_tensors + [None] * n_scalars)
                for p in (Shard(0), Shard(1), Replicate())]

    register_sharding(ops.flash_fwd.default)(lambda q, k, v, scale: alike(2, 3, 1))
    register_sharding(ops.flash_dq.default)(
        lambda q, k, v, do, lse, delta, scale: alike(1, 6, 1))
    register_sharding(ops.flash_dkv.default)(
        lambda q, k, v, do, lse, delta, scale: alike(2, 6, 1))
    register_sharding(ops.nearest_upsample_2x.default)(lambda x: alike(1, 1, 0))
