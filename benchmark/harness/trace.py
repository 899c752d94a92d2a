"""A traced stretch of calls and the reduction of its events.

`profile` runs calls under `torch.profiler` (host and device), with the
driver's spans open, and reads the profiler's raw events (building its
event tree would cost minutes for tens of thousands of kernels) into a
`Trace`:

- `kernels`: every device operation (kernel, copy, set), (start_us, end_us,
  name, correlation id);
- `launch_at`: correlation id -> host time of the CUDA runtime or driver
  call that enqueued it; `launches`: how many such calls there were
  (kernel and graph launches, copies, sets);
- `spans`: (start_us, end_us, name) of the benchmark's spans, of the
  autograd engine's backward functions (named `backward`) and of the
  attention ops.

A device operation belongs to a span when the host call that enqueued it
lies inside that span. The host threads run one after the other here (the
caller waits while the autograd engine runs the backward), so time alone
decides.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Iterable, List, Tuple

import torch

BACKWARD_PREFIX = "autograd::engine::evaluate_function"
CALL_SPAN = "call"
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
    "cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset",
    "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2", "cuMemsetD8Async",
    "cuMemsetD32Async",
})


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end] intervals, as sorted disjoint ones."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def length(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in union(intervals))


@dataclass
class Trace:
    kernels: list
    launch_at: dict
    launches: int
    spans: list
    wall_s: float

    @property
    def window(self) -> Tuple[float, float]:
        calls = [(a, b) for a, b, name in self.spans if name == CALL_SPAN]
        return min(a for a, _ in calls), max(b for _, b in calls)

    def kernels_in(self, names) -> list:
        """The device operations enqueued inside spans named in `names`."""
        cover = union((a, b) for a, b, name in self.spans if name in names)
        starts = [a for a, _ in cover]
        out = []
        for kernel in self.kernels:
            at = self.launch_at.get(kernel[3])
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= cover[i][1]:
                out.append(kernel)
        return out

    def busy_us(self, kernels=None) -> float:
        return length((k[0], k[1]) for k in (self.kernels if kernels is None else kernels))

    def innermost_span(self, at: float):
        open_spans = [(a, name) for a, b, name in self.spans if a <= at <= b]
        return max(open_spans)[1] if open_spans else None

    def idle_gaps(self, n: int) -> list:
        """The `n` longest stretches of the window with no device operation
        running, each named after the innermost span open at its middle:
        [[name, seconds], ...]."""
        start, end = self.window
        gaps, busy_to = [], start
        for a, b in union((k[0], k[1]) for k in self.kernels):
            if a > busy_to:
                gaps.append((busy_to, min(a, end)))
            busy_to = max(busy_to, b)
        if end > busy_to:
            gaps.append((busy_to, end))
        gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n]
        return [[self.innermost_span((a + b) / 2) or "outside", (b - a) / 1e6] for a, b in gaps]

    def top_ops(self, n: int) -> list:
        totals = {}
        for a, b, name, _ in self.kernels:
            totals[name] = totals.get(name, 0.0) + (b - a)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]


@dataclass
class Reading:
    """What a per-layer metric's reader reads: the traced stretch (`calls`
    calls, `steps` steps), the untraced window's `ms_per_step`, the model
    FLOPs of a step and the attention ops of one call as counted by
    `harness.flops`, and the card's peaks."""

    trace: Trace
    steps: int
    ms_per_step: float
    flops_per_step: float
    attention_per_call: list
    calls: int
    attention_ops: dict
    peak_flops: float
    peak_bytes: float


def profile(call, n_calls: int, spans, span_names: Iterable[str], synchronize) -> Trace:
    """Run `call()` `n_calls` times under the profiler with `spans` on,
    each call inside a span named CALL_SPAN."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    names = set(span_names) | {CALL_SPAN}
    spans.on = True
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_calls):
                with record_function(CALL_SPAN):
                    call()
                synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        spans.on = False
    kernels, launch_at, launches, host_spans = [], {}, 0, []
    for event in prof.profiler.kineto_results.events():
        name = event.name()
        start, end = event.start_ns() / 1e3, event.end_ns() / 1e3
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            if not (event.is_user_annotation() or name in names):
                kernels.append((start, end, name, event.correlation_id()))
        elif name in LAUNCH_CALLS:
            launches += 1
            launch_at[event.correlation_id()] = start
        elif name.startswith(BACKWARD_PREFIX):
            host_spans.append((start, end, "backward"))
        elif name in names:
            host_spans.append((start, end, name))
    return Trace(kernels, launch_at, launches, host_spans, wall_s)
