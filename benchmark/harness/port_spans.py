"""The port's own spans, joined with a traced stretch's device work.

While a profiler runs, the port logs each of its spans in memory
(`perceptor_tpu_torch.utils.profiling.spans()`: name, parent, ids, thread,
start and end in ns of `time.time_ns()`, the clock the profiler's events
are converted to). `in_window` takes those that overlap the traced window,
as (start_us, end_us, name, parent). A device operation belongs to a port
span when the host call that enqueued it lies inside that span, as for the
benchmark's own spans (`harness.trace`). A port that keeps no such log
gives no spans, and every reader here None.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from benchmark.harness import trace

Span = Tuple[float, float, str, Optional[str]]


def port_log() -> list:
    """The port's span log, or [] where the port keeps none."""
    from perceptor_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else []


def in_window(reading, log: Iterable = None) -> List[Span]:
    """The port's spans (of `log`, by default the port's own) that overlap
    the traced window, in µs."""
    start, end = reading.trace.window
    out = []
    for record in port_log() if log is None else log:
        a, b = record.start_ns / 1e3, record.end_ns / 1e3
        if a <= end and b >= start:
            out.append((a, b, record.name, record.parent))
    return out


def kernels_in(reading, spans: Iterable[Span]) -> list:
    """The device operations whose host launch lies inside one of `spans`."""
    spans = [(a, b, name) for a, b, name, _ in spans]
    joined = dataclasses.replace(reading.trace, spans=spans)
    return joined.kernels_in({name for _, _, name in spans})


def device_ms_per_step(reading, name: str, log: Iterable = None) -> Optional[float]:
    """Device ms a step (the union of intervals) of the work launched inside
    the port's spans named `name`; None where the port logged none."""
    spans = [s for s in in_window(reading, log) if s[2] == name]
    if not spans:
        return None
    return reading.trace.busy_us(kernels_in(reading, spans)) / 1e3 / reading.steps


def intersection(a: list, b: list) -> list:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def host_ms_per_step(reading, names: Iterable[str], less: Iterable[str] = (),
                     log: Iterable = None) -> Optional[float]:
    """Host ms a step inside the port's spans named in `names`, clipped to
    the window, less the time of their children named in `less`; None where
    the port logged none."""
    names, less = set(names), set(less)
    start, end = reading.trace.window
    spans = in_window(reading, log)
    if not any(name in names for _, _, name, _ in spans):
        return None

    def us(kept):
        return sum(min(b, end) - max(a, start) for a, b, name, parent in spans if kept(name, parent))

    held = us(lambda name, _: name in names) - us(lambda name, parent: name in less and
                                                   parent in names)
    return held / 1e3 / reading.steps


def idle_in_program(reading, log: Iterable = None) -> Optional[Tuple[float, float]]:
    """(µs of the window's device-idle time during which a root span of the
    port, one opened with no span of the port open, was open; µs of the
    window's device-idle time): the idle time the port's host code holds,
    and the caller's beside it. None where the port logged no root span."""
    roots = [(a, b) for a, b, _, parent in in_window(reading, log) if parent is None]
    if not roots:
        return None
    start, end = reading.trace.window
    idle, busy_to = [], start
    for a, b in trace.union((k[0], k[1]) for k in reading.trace.kernels):
        if a > busy_to:
            idle.append((busy_to, min(a, end)))
        busy_to = max(busy_to, b)
        if busy_to >= end:
            break
    if end > busy_to:
        idle.append((busy_to, end))
    idle = [(a, b) for a, b in idle if b > a]
    return trace.length(intersection(idle, trace.union(roots))), trace.length(idle)


def idle_in_program_share(reading, log: Iterable = None) -> Optional[float]:
    """% of the window's device-idle time held inside the port's root spans;
    0 where the device never idled."""
    idle = idle_in_program(reading, log)
    if idle is None:
        return None
    held, total = idle
    return 100.0 * held / total if total else 0.0


def idle_in_program_ms_per_step(reading, log: Iterable = None) -> Optional[float]:
    """Device-idle ms a step held inside the port's root spans."""
    idle = idle_in_program(reading, log)
    return None if idle is None else idle[0] / 1e3 / reading.steps
