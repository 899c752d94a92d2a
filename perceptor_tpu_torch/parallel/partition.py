"""Parameter partitioning: regex path rules -> DTensor placements
(counterpart of perceptor_tpu/parallel/partition.py).

Megatron-style tensor-parallel rules over the port's parameter names:
column-parallel layers shard their output features, row-parallel layers
their input features. torch stores a linear weight (out, in) and a conv
weight (out, in, kh, kw) where flax stores (in, out) and (kh, kw, in, out),
so column-parallel is dim 0 here (JAX: the last dim) and row-parallel dim 1
(JAX: the second-to-last). A spec is a `PartitionSpec`, one mesh axis name
or None per tensor dim, as in JAX; `placements` turns it into DTensor
placements.

The port's `sample(mesh=)` paths place the parameters by these rules
(`shard_params`, once per module and mesh: `placed_params`), and each call
of a layer gathers its sharded ones (`gathered_params`): DTensor has no strategy that keeps a convolution's
output channels, or a spatially sharded convolution, sharded the way GSPMD
does, so the layers compute on gathered weights, replicated over the
tensor and context ranks, and every gather shows in the traced program
(`utils.hlo.collective_counts`).
"""

from __future__ import annotations

import dataclasses
import re
import weakref
from contextlib import contextmanager
from typing import Dict, Mapping, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map, tree_map_with_path

from perceptor_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_TENSOR, axis_size


class PartitionSpec(tuple):
    """One mesh axis name (or None) per tensor dim; shorter specs leave the
    trailing dims replicated. `PartitionSpec()` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class PartitionRules:
    """Ordered (regex, spec) list; first match wins. A spec is a
    PartitionSpec or `spec_fn(shape) -> PartitionSpec`; no match
    replicates. `partition_params` demotes a spec whose sharded dim does not
    divide by the mesh axis size to replication."""

    def __init__(self, rules: Sequence[Tuple[str, object]]):
        self.rules = [(re.compile(pattern), spec) for pattern, spec in rules]

    def spec_for(self, path: str, shape) -> PartitionSpec:
        for pattern, spec in self.rules:
            if pattern.search(path):
                return spec(shape) if callable(spec) else spec
        return P()


def _col(axis=AXIS_TENSOR):
    """Shard dim 0: a torch weight's output features."""
    return lambda shape: P(axis) if len(shape) >= 1 else P()


def _row(axis=AXIS_TENSOR):
    """Shard dim 1: a torch weight's input features."""
    return lambda shape: P(None, axis) if len(shape) >= 2 else P()


# Tensor-parallel rules for the StableDiffusion UNet, VAE and CLIP text
# encoder (JAX's rules under the port's names): q/k/v and the first MLP
# projection column-parallel, output projections row-parallel, the resnet
# convs and the time embedding projection column-parallel; everything else
# (stems, shortcuts, norms, the text encoder's fused in_proj) replicated.
SD_TENSOR_PARALLEL_RULES = PartitionRules(
    [
        (r"(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.weight$", _col()),
        (r"(to_out\.0|out_proj)\.weight$", _row()),
        (r"(net\.0\.proj|fc1|c_fc)\.weight$", _col()),
        (r"(net\.2|fc2|c_proj)\.weight$", _row()),
        (r"(conv1|conv2)\.weight$", _col()),
        (r"time_emb_proj\.weight$", _col()),
        (r".*", P()),
    ]
)


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def placements(spec: PartitionSpec, mesh):
    """DTensor placements (one per mesh dim) of a PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard

    from perceptor_tpu_torch.parallel import strategies

    strategies.register()
    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    # a mesh dim of one rank holds the whole tensor: Replicate, no copy
    return [Shard(dims[name]) if name in dims and mesh.size(i) > 1 else Replicate()
            for i, name in enumerate(mesh.mesh_dim_names)]


def _check_device(tree, mesh) -> None:
    """Raise unless every tensor of `tree` lies on the mesh's device type:
    DTensor would copy it there (CUDA weights onto a gloo mesh's CPU)."""
    for leaf in torch.utils._pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != mesh.device_type:
            raise ValueError(
                f"a tensor on {leaf.device} and a {mesh.device_type} mesh: bring up the "
                "process group on the tensors' device (initialize_distributed(device=...))")


def partition_params(params, rules: PartitionRules, mesh):
    """A tree of tensors (nested dicts keyed by names) -> the same tree of
    PartitionSpecs, divisibility-checked. Paths join the keys with "/"."""

    def spec(path, leaf):
        s = rules.spec_for(_path_str(path), tuple(leaf.shape))
        for dim, axis in enumerate(s):
            if axis is not None and leaf.shape[dim] % axis_size(mesh, axis):
                return P()
        return s

    return tree_map_with_path(spec, params)


def shard_params(params, mesh, rules: PartitionRules = SD_TENSOR_PARALLEL_RULES):
    """Place a tree of tensors onto the mesh under the partition rules:
    DTensors, sharded where a rule says so, replicated elsewhere. Every rank
    holds the same tree (the same checkpoint or seed), as JAX's
    `device_put` of a host tree assumes: each keeps its own shard of its
    own copy and no bytes move between ranks (a replicated DTensor's local
    tensor is the tree's own)."""
    from torch.distributed.tensor import distribute_tensor

    _check_device(params, mesh)
    specs = partition_params(params, rules, mesh)
    flat_specs = iter(torch.utils._pytree.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec)))
    return tree_map(lambda leaf: distribute_tensor(
        leaf, mesh, placements(next(flat_specs), mesh), src_data_rank=None), params)


def shard_batch(tree, mesh, axis: str = AXIS_DATA):
    """Shard the leading (batch) dim of every tensor over the data axis."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda leaf: distribute_tensor(leaf, mesh, placements(P(axis), mesh)), tree)


def replicate(tree, mesh):
    """Every tensor of `tree` replicated over the mesh."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda leaf: distribute_tensor(leaf, mesh, placements(P(), mesh)), tree)


def shard_for_sampling(mesh, params, latents, *replicated, rules=None):
    """The common `sample(mesh=)` plumbing of the family samplers: params
    placed by the tensor-parallel rules, the latent batch sharded over the
    data axis when it divides (replicated otherwise), everything else
    replicated. Under a mesh with a context axis (parallel/plan.py) the
    latents shard spatially (H over context) instead. Returns
    ``(params, latents, *replicated)``; None entries pass through."""
    params = shard_params(params, mesh, **({} if rules is None else {"rules": rules}))
    reps = tuple(replicate(r, mesh) if r is not None else None for r in replicated)
    return (params, _place_latents(mesh, latents)) + reps


def _place_latents(mesh, latents):
    """The latents on the mesh: H sharded over the context axis under a
    plan, else the batch over the data axis when it divides, else
    replicated."""
    from torch.distributed.tensor import distribute_tensor

    from perceptor_tpu_torch.parallel.plan import plan_for_mesh

    _check_device(latents, mesh)
    plan = plan_for_mesh(mesh)
    if plan is not None and latents.ndim >= 3 and latents.shape[2] % plan.n_context == 0:
        return distribute_tensor(latents, mesh, plan.spatial_spec(latents.ndim, 2,
                                                                  latents.shape[0]))
    if latents.shape[0] % axis_size(mesh, AXIS_DATA) == 0:
        return shard_batch(latents, mesh)
    return replicate(latents, mesh)


# module -> {(mesh, rules): ((weakref, version, data_ptr) of its tensors, placed)}
_PLACED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def placed_params(module: torch.nn.Module, mesh, rules=None) -> Dict[str, torch.Tensor]:
    """`shard_params` of a module's parameters and buffers, kept for the
    next call with the same mesh and rules as long as the module holds the
    same tensors on the same storage, unchanged in place (a loaded or
    updated tensor places the module anew)."""
    from perceptor_tpu_torch.utils.serving import module_params

    params = module_params(module)
    entries = _PLACED.setdefault(module, {})
    key = (mesh, rules)
    hit = entries.get(key)
    if hit is not None and len(hit[0]) == len(params) and all(
            ref() is t and (version, ptr) == (t._version, t.data_ptr())
            for (ref, version, ptr), t in zip(hit[0], params.values())):
        return hit[1]
    placed = shard_params(params, mesh, **({} if rules is None else {"rules": rules}))
    entries[key] = ([(weakref.ref(t), t._version, t.data_ptr()) for t in params.values()],
                    placed)
    return placed


def is_sharded(tensor: torch.Tensor) -> bool:
    """Whether a DTensor is split over some mesh dim of more than one rank
    (its local tensor is then not its global value)."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(tensor, DTensor) and any(
        isinstance(p, Shard) and tensor.device_mesh.size(i) > 1
        for i, p in enumerate(tensor.placements))


@contextmanager
def gathered_params(modules: Mapping[str, torch.nn.Module],
                    sharded: Mapping[str, Mapping[str, torch.Tensor]]):
    """While in scope, the modules `modules[part]` compute on the tensors
    of `sharded[part]` (name -> DTensor, as `shard_params` placed them, or
    plain tensors). Those that are whole on every rank (replicated, or on
    mesh dims of one rank) are swapped in once; the sharded ones are
    gathered at each call of the submodule that holds them (an all-gather)
    and swapped back after it, as FSDP does. The modules' own tensors are
    in place again on exit."""
    from torch.distributed.tensor import DTensor

    def swap(module: torch.nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
        for leaf, value in tensors.items():
            if leaf in module._parameters:
                module._parameters[leaf] = (value if isinstance(value, torch.nn.Parameter)
                                            else torch.nn.Parameter(value, requires_grad=False))
            else:
                module._buffers[leaf] = value

    owned, handles = [], []
    for part, module in modules.items():
        for prefix, sub in module.named_modules():
            own = {name: t for name, t in (*sub._parameters.items(), *sub._buffers.items())
                   if t is not None}
            if not own:
                continue
            dotted = prefix + "." if prefix else ""
            # a tensor tied under an earlier name is listed once; it keeps its own
            placed = {name: sharded[part].get(dotted + name, t) for name, t in own.items()}
            whole = {name: t.to_local() if isinstance(t, DTensor) else t
                     for name, t in placed.items() if not is_sharded(t)}
            split = {name: t for name, t in placed.items() if is_sharded(t)}
            owned.append((sub, own))
            swap(sub, whole)
            if not split:
                continue

            def pre_hook(mod, args, _split=split):
                swap(mod, {name: t.full_tensor() for name, t in _split.items()})

            def post_hook(mod, args, output, _own=own, _split=split):
                swap(mod, {name: _own[name] for name in _split})

            handles += [sub.register_forward_pre_hook(pre_hook),
                        sub.register_forward_hook(post_hook)]
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()
        for sub, own in owned:
            swap(sub, own)


class MeshSampling:
    """What a sampler needs inside `sampling`: this rank's latents (its
    data shard of the batch, gathered over every other mesh dim), `rows`
    to cut any batch-leading tensor to the same shard, and `gather` to put
    a local result back together on every rank (differentiable)."""

    def __init__(self, mesh, placed):
        from torch.distributed.tensor import Replicate, Shard

        names = mesh.mesh_dim_names
        data = AXIS_DATA in names and any(
            name == AXIS_DATA and p == Shard(0) for name, p in zip(names, placed.placements))
        self.mesh = mesh
        self.batch = placed.shape[0]
        self.placements = [Shard(0) if name == AXIS_DATA and data else Replicate()
                           for name in names]
        self.n = axis_size(mesh, AXIS_DATA) if data else 1
        self.index = mesh.get_local_rank(AXIS_DATA) if data else 0
        self.latents = placed.redistribute(mesh, self.placements).to_local()

    def rows(self, value):
        """`value`'s rows of this rank's data shard: a tensor whose leading
        dim is the batch, or a dataclass of such tensors; else as it is."""
        if self.n == 1 or value is None:
            return value
        if isinstance(value, torch.Tensor):
            return value.chunk(self.n)[self.index] if value.shape[:1] == (self.batch,) else value
        if dataclasses.is_dataclass(value):
            return dataclasses.replace(value, **{
                f.name: self.rows(getattr(value, f.name)) for f in dataclasses.fields(value)
                if isinstance(getattr(value, f.name), torch.Tensor)})
        return value

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch from each data rank's `local` rows."""
        if self.n == 1:
            return local
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, self.placements, run_check=False).full_tensor()


@contextmanager
def sampling(mesh, modules: Mapping[str, torch.nn.Module], latents, rules=None):
    """The scope of a sampler's `mesh=` path: the parameters and buffers of
    `modules` (part -> module) placed by the rules (`placed_params`, once
    per module, mesh and rules) and gathered per layer call
    (`gathered_params`), the latents placed on the mesh, and the
    context-parallel plan of the mesh active. Yields a `MeshSampling`; the
    sampler runs on its `latents` and returns its `gather` of the result."""
    from perceptor_tpu_torch.parallel.plan import activate, plan_for_mesh

    sharded = {part: placed_params(module, mesh, rules) for part, module in modules.items()}
    placed = _place_latents(mesh, latents)
    with gathered_params(modules, sharded), activate(plan_for_mesh(mesh)):
        yield MeshSampling(mesh, placed)
