"""Device mesh and process-group bring-up over torch.distributed
(counterpart of perceptor_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, with named dims in JAX's order: "data"
outermost, then "stage", "context" and "tensor" innermost.
`initialize_distributed` brings up the process group (NCCL on the card
unless the caller asks for gloo on the CPU); `create_hybrid_mesh` puts the
hosts (the granules: ranks that share a machine, and so NVLink) outermost
on the data axis; `global_batch_from_local` assembles a data-parallel batch
from each rank's shard as a DTensor.

Where the JAX functions take `devices`, these take ranks.
"""

from __future__ import annotations

import socket
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from perceptor_tpu_torch.core.init import resolve_device
from perceptor_tpu_torch.parallel import strategies

AXIS_DATA = "data"
AXIS_TENSOR = "tensor"
AXIS_CONTEXT = "context"
AXIS_STAGE = "stage"

_DEFAULT_ORDER = (AXIS_DATA, AXIS_STAGE, AXIS_CONTEXT, AXIS_TENSOR)


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.initialize_distributed first")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _ranks(devices: Optional[Sequence[int]]) -> list:
    _require_group()
    return list(devices) if devices is not None else list(range(dist.get_world_size()))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh dim named `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def create_mesh(
    data: int = -1,
    tensor: int = 1,
    context: int = 1,
    stage: int = 1,
    devices: Optional[Sequence[int]] = None,
    axis_order: Tuple[str, ...] = _DEFAULT_ORDER,
) -> DeviceMesh:
    """A named mesh over `devices` (ranks; default every rank of the
    process group); `data=-1` absorbs the remaining ranks."""
    ranks = _ranks(devices)
    sizes = {AXIS_DATA: data, AXIS_TENSOR: tensor, AXIS_CONTEXT: context, AXIS_STAGE: stage}
    fixed = tensor * context * stage
    if data == -1:
        if len(ranks) % fixed:
            raise ValueError(
                f"{len(ranks)} devices not divisible by tensor*context*stage={fixed}")
        sizes[AXIS_DATA] = len(ranks) // fixed
    total = sizes[AXIS_DATA] * fixed
    if total != len(ranks):
        raise ValueError(f"mesh size {total} != device count {len(ranks)}")
    shape = tuple(sizes[a] for a in axis_order)
    strategies.register()
    return DeviceMesh(_device_type(), torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_order))


def free_port() -> int:
    """A free TCP port on localhost, for a one-host rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    **kwargs,
) -> None:
    """Bring up the default process group: NCCL on a CUDA `device` (the
    default; made the current one, the current one when no index is
    given), gloo when the caller asks for "cpu". `coordinator_address` is
    the rendezvous, "host:port" or a URL such as "tcp://localhost:29500";
    with one process and none given, a free localhost port.
    `num_processes` and `process_id` are the world size and this rank.
    Idempotent: a second call is a no-op. `kwargs` go to
    `init_process_group` (a `timeout=` makes a hung collective raise)."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if coordinator_address is None:
        if world != 1:
            raise ValueError("a world of several processes needs a coordinator_address")
        coordinator_address = f"localhost:{free_port()}"
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kwargs.setdefault("device_id", device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=coordinator_address, world_size=world, rank=rank,
                            **kwargs)


_HOSTS: dict = {}


def _granule_id(rank: int) -> int:
    """The host of `rank`, numbered in order of first appearance. The host
    names are gathered once, a collective every rank must join."""
    if not _HOSTS:
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname())
        order = {name: i for i, name in enumerate(dict.fromkeys(names))}
        _HOSTS.update({r: order[name] for r, name in enumerate(names)})
    return _HOSTS[rank]


def group_by_granule(devices: Sequence[int], granule_key: Optional[Callable] = None):
    """Group ranks into equal-size granules (sorted by granule id); the
    default granule is the host. Raises if granules are unequal."""
    key = granule_key or _granule_id
    groups: dict = {}
    for d in devices:
        groups.setdefault(key(d), []).append(d)
    granules = [groups[k] for k in sorted(groups)]
    if len({len(g) for g in granules}) != 1:
        raise ValueError(f"unequal DCN granules: {[len(g) for g in granules]} devices")
    return granules


def create_hybrid_mesh(
    data_dcn: int = -1,
    data: int = 1,
    tensor: int = 1,
    context: int = 1,
    stage: int = 1,
    devices: Optional[Sequence[int]] = None,
    axis_order: Tuple[str, ...] = _DEFAULT_ORDER,
    granule_key: Optional[Callable] = None,
) -> DeviceMesh:
    """A mesh whose "data" axis spans the granules outermost (size
    `data_dcn * data`), the inner axes within a granule: only the data
    axis's collectives leave a host. `data_dcn=-1` takes every granule,
    `data=-1` the remaining ranks of each. One granule gives `create_mesh`'s
    mesh."""
    ranks = _ranks(devices)
    granules = group_by_granule(ranks, granule_key)
    if data_dcn == -1:
        data_dcn = len(granules)
    if data_dcn != len(granules):
        raise ValueError(
            f"data_dcn={data_dcn} != {len(granules)} DCN granules; pass the "
            f"devices of exactly the granules you want")
    per_granule = len(granules[0])
    inner_fixed = tensor * context * stage
    if data == -1:
        if per_granule % inner_fixed:
            raise ValueError(f"{per_granule} devices/granule not divisible by "
                             f"tensor*context*stage={inner_fixed}")
        data = per_granule // inner_fixed
    if data * inner_fixed != per_granule:
        raise ValueError(f"inner mesh size {data * inner_fixed} != granule size {per_granule}")
    sizes = {AXIS_DATA: data, AXIS_TENSOR: tensor, AXIS_CONTEXT: context, AXIS_STAGE: stage}
    inner_shape = tuple(sizes[a] for a in axis_order)
    stacked = np.stack([np.asarray(g).reshape(inner_shape) for g in granules], axis=0)
    data_pos = axis_order.index(AXIS_DATA)
    stacked = np.moveaxis(stacked, 0, data_pos)
    shape = list(inner_shape)
    shape[data_pos] = data_dcn * data
    strategies.register()
    return DeviceMesh(_device_type(), torch.as_tensor(stacked.reshape(shape)),
                      mesh_dim_names=tuple(axis_order))


def global_batch_from_local(local_batch, mesh: DeviceMesh, axis: str = AXIS_DATA):
    """The global data-parallel batch from each rank's shard: every tensor
    leaf (leading dim = global batch / data ranks) becomes a DTensor sharded
    on dim 0 over `axis`, replicated over the other mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._pytree import tree_map

    placements = [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]

    def place(leaf):
        return DTensor.from_local(torch.as_tensor(leaf), mesh, placements, run_check=False)

    return tree_map(place, local_batch)
