"""Context-parallel plan: routes model-layer attention through the
ring/Ulysses collectives (counterpart of perceptor_tpu/parallel/plan.py).

A plan is a routing context that `ops.attention.attention` consults: under a
mesh with a `context` axis, long self-attention runs as ring attention
(parallel/ring_attention.py) and cross-attention as Ulysses head-sharded
attention (parallel/ulysses.py), without any model passing a mesh through
its layers::

    mesh = parallel.create_mesh(data=1, context=2)
    with parallel.context_parallel(mesh):
        out = unet(latents, t, ctx)              # ring/Ulysses inside

`StableDiffusion.sample(mesh=...)` and the other samplers activate the
plan when the mesh has a context axis of size > 1. The routing rules and
their reasons are JAX's, string for string (the plain route is named
"xla", as in JAX, wherever a record names it).

Decisions are recorded when the attention runs: eagerly, or under
`explain`, which runs the function on fake tensors
(`torch._subclasses.FakeTensorMode`, the counterpart of `jax.eval_shape`),
so that nothing is computed. Fake tensors keep the device of the real ones:
on a CPU-only build no CUDA tensor exists, so `explain` reports the routes
a CPU run takes, as JAX's does on a CPU device.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager, nullcontext
from typing import Optional

from perceptor_tpu_torch.parallel.mesh import AXIS_CONTEXT, AXIS_DATA, axis_size

RING = "ring"
ULYSSES = "ulysses"


@dataclasses.dataclass(frozen=True)
class ContextParallelPlan:
    """Static routing decisions for one mesh (JAX's rules and defaults).

    ``ring_min_shard``: per-rank tokens (seq/n) at which the ring is
    preferred over everything. ``ring_min_seq``: below ``ring_min_shard``
    shards, head-divisible shapes take Ulysses; shapes Ulysses cannot serve
    still ride the ring when the global sequence is at least this long.
    Anything else takes the plain attention."""

    mesh: object
    context_axis: str = AXIS_CONTEXT
    batch_axis: Optional[str] = AXIS_DATA
    ring_min_seq: int = 1024
    ring_min_shard: int = 1024

    @property
    def n_context(self) -> int:
        return axis_size(self.mesh, self.context_axis)

    def route(self, seq_q: int, seq_k: int, heads: int, masked: bool = False) -> Optional[str]:
        """Which collective (if any) serves this attention shape."""
        return self.route_explain(seq_q, seq_k, heads, masked=masked)[0]

    def route_explain(self, seq_q: int, seq_k: int, heads: int, masked: bool = False):
        """(route, reason): the collective serving this attention shape and
        why; every None carries the rule that rejected the shape."""
        n = self.n_context
        if masked:
            return None, "masked attention stays on the XLA path"
        if n <= 1:
            return None, "context axis is trivial (size 1)"
        ring_ok = seq_q == seq_k and seq_q % n == 0 and seq_q >= self.ring_min_seq
        if ring_ok and seq_q // n >= self.ring_min_shard:
            return RING, (
                f"self-attention, shard {seq_q // n} >= ring_min_shard "
                f"{self.ring_min_shard} (bandwidth-clean ring; measured "
                "compute/comm >= 2.6) and divisible by context axis "
                f"{n}"
            )
        if heads % n == 0:
            reason = (
                f"cross-attention (seq_q {seq_q} != seq_k {seq_k})"
                if seq_q != seq_k
                else (
                    f"self-attention seq {seq_q} below ring_min_seq "
                    f"{self.ring_min_seq}"
                    if seq_q < self.ring_min_seq
                    else (
                        f"self-attention shard {seq_q // n} below "
                        f"ring_min_shard {self.ring_min_shard} — Ulysses "
                        f"moves {n}/2x fewer ICI bytes than a comm-bound "
                        "ring"
                        if seq_q % n == 0
                        else f"self-attention seq {seq_q} not divisible "
                        f"by context axis {n}"
                    )
                )
            )
            return ULYSSES, reason + f"; heads {heads} divisible by {n}"
        if ring_ok:
            return RING, (
                f"self-attention, seq {seq_q} >= ring_min_seq "
                f"{self.ring_min_seq} and divisible by context axis {n}; "
                f"heads {heads} not Ulysses-divisible — comm-bound ring "
                "still scales memory 1/n"
            )
        return None, (
            f"no route: seq_q {seq_q} (vs seq_k {seq_k}) not ring-eligible "
            f"and heads {heads} not divisible by context axis {n} — "
            "GSPMD/XLA handles the sharded operands"
        )

    def spatial_spec(self, ndim: int, h_axis: int, batch: int):
        """DTensor placements (one per mesh dim) sharding tensor dim `h_axis`
        over the context axis, and dim 0 over the batch axis when it
        divides; the counterpart of JAX's PartitionSpec."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.mesh.mesh_dim_names
        data = (self.batch_axis if self.batch_axis in names
                and batch % axis_size(self.mesh, self.batch_axis) == 0 else None)
        return [Shard(h_axis % ndim) if name == self.context_axis
                else Shard(0) if name == data else Replicate() for name in names]


_local = threading.local()


@dataclasses.dataclass
class RouteRecord:
    """One attention/sharding site as it ran."""

    site: str  # "attention" | "shard_spatial"
    shape: tuple  # attention: (seq_q, seq_k, heads); spatial: tensor shape
    route: Optional[str]  # ring/ulysses/flash/xla/sharded; None = fallback
    reason: str
    count: int = 1


class RoutingReport:
    """Aggregated routing decisions (deduped per site, shape, route and
    reason)."""

    def __init__(self):
        self._records = {}

    def add(self, site, shape, route, reason):
        key = (site, tuple(shape), route, reason)
        rec = self._records.get(key)
        if rec is None:
            self._records[key] = RouteRecord(site, tuple(shape), route, reason)
        else:
            rec.count += 1

    @property
    def records(self):
        return list(self._records.values())

    def routes(self):
        """{route: total count} over all records."""
        out = {}
        for rec in self.records:
            out[rec.route] = out.get(rec.route, 0) + rec.count
        return out

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self._records)

    def summary(self) -> str:
        if not self._records:
            return "no routing decisions recorded (nothing ran in scope)"
        lines = []
        for rec in self.records:
            label = rec.route if rec.route is not None else "FALLBACK"
            lines.append(f"{rec.site} {rec.shape} x{rec.count}: {label} — {rec.reason}")
        return "\n".join(lines)


@contextmanager
def record_routing():
    """Collect the attention/sharding routing decisions made in this scope::

        with parallel.record_routing() as report:
            step(latents)
        print(report.summary())
    """
    report = RoutingReport()
    prev = getattr(_local, "recorder", None)
    _local.recorder = report
    try:
        yield report
    finally:
        _local.recorder = prev


def record_route(site: str, shape, route: Optional[str], reason: str) -> None:
    """Record one routing decision into the active recorder (no-op
    otherwise). Called by ops.attention and shard_spatial."""
    report = getattr(_local, "recorder", None)
    if report is not None:
        report.add(site, shape, route, reason)


def explain(fn, *args, mesh=None, **kwargs) -> RoutingReport:
    """Run `fn(*args, **kwargs)` on fake tensors (no compute) under a
    context-parallel plan for `mesh` (or the already active plan when mesh
    is None) and report which route every attention site took."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    plan = plan_for_mesh(mesh) if mesh is not None else None
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args, kwargs = tree_map(
        lambda x: mode.from_tensor(x) if isinstance(x, torch.Tensor) else x, (args, kwargs))
    with activate(plan), record_routing() as report, mode:
        fn(*args, **kwargs)
    return report


def current_plan() -> Optional[ContextParallelPlan]:
    """The active plan, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def context_parallel(mesh, **kwargs):
    """Activate context-parallel routing for attention calls in scope.
    `mesh` is a DeviceMesh (a plan is built with `kwargs`) or a plan."""
    plan = mesh if isinstance(mesh, ContextParallelPlan) else ContextParallelPlan(mesh, **kwargs)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(plan)
    try:
        yield plan
    finally:
        stack.pop()


def activate(plan: Optional[ContextParallelPlan]):
    """The plan's scope as a context manager, or a no-op for None."""
    return context_parallel(plan) if plan is not None else nullcontext()


def plan_for_mesh(mesh, **kwargs) -> Optional[ContextParallelPlan]:
    """A plan for a mesh IF it has a context axis of size > 1, else None."""
    if mesh is None or AXIS_CONTEXT not in (mesh.mesh_dim_names or ()):
        return None
    if axis_size(mesh, AXIS_CONTEXT) <= 1:
        return None
    return ContextParallelPlan(mesh, **kwargs)


def shard_spatial(x, h_axis: int = 1):
    """Pin an activation's spatial dim `h_axis` to the context axis under
    the active plan (no-op without one) and record what was done. A DTensor
    is redistributed to the plan's spatial placements ("sharded"). A plain
    tensor is returned as it is and recorded as a fallback: the port's mesh
    samplers run the convolutions on activations replicated over the
    context axis, since DTensor has no halo exchange for a spatially
    sharded convolution."""
    plan = current_plan()
    if plan is None:
        return x
    if x.shape[h_axis] % plan.n_context:
        record_route(
            "shard_spatial", tuple(x.shape), None,
            f"spatial dim {x.shape[h_axis]} (axis {h_axis}) not divisible "
            f"by context axis {plan.n_context} — activation left unsharded",
        )
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        record_route(
            "shard_spatial", tuple(x.shape), None,
            f"plain tensor — activation replicated over context axis "
            f"{plan.n_context} (no halo exchange for a spatially sharded "
            "convolution in DTensor)",
        )
        return x
    spec = plan.spatial_spec(x.ndim, h_axis, x.shape[0])
    record_route(
        "shard_spatial", tuple(x.shape), "sharded",
        f"spatial dim {x.shape[h_axis]} pinned to context axis "
        f"{plan.n_context} ({tuple(spec)})",
    )
    return x.redistribute(plan.mesh, spec)
