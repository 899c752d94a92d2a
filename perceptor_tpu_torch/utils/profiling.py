"""Runtime observability (counterpart of perceptor_tpu/utils/profiling.py):

  - `trace(logdir)`: `torch.profiler` over the enclosed block, host and
    device activity, written to `logdir` as a Chrome trace;
  - `annotate(name, **ids)`: the port's span. While a profiler runs it
    opens `record_function(name)` (its args the ids, so the trace shows
    it) and logs a `SpanRecord`; otherwise it is one shared null context,
    and under `torch.compile` or `torch.export` tracing always, so no
    program holds a span;
  - `backward_span(name, inputs, outputs)`: `<name>.backward`, from the
    first gradient to reach `outputs` to that of the last of `inputs`
    (tensor and node hooks, added only while a profiler runs);
  - `spans()` / `clear_spans()`: the log of closed spans, at most
    SPAN_LOG_LIMIT, the oldest dropped first, stamped with `time.time_ns()`,
    the clock the profiler's events are converted to, so a span joins the
    device work its launches enqueued;
  - `StepTimer`: wall time per step, ended by a device synchronize on the
    probed tensor's device, with the JAX summary's keys;
  - `memory_stats()` / `live_array_bytes()`: the CUDA caching allocator's
    occupancy under JAX's key names, `{}` / 0 on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (the CPU, and CUDA where there is one) and
    write `logdir/trace_<pid>_<ms>.json`; yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


SPAN_LOG_LIMIT = 1 << 16
_NULL_SPAN = contextlib.nullcontext()
_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG_LIMIT)
_OPEN: List["_Span"] = []  # open spans of every thread, oldest first
_OPEN_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """A closed span: `parent` is the name of the span open when it opened
    (on its own thread, else the newest on any thread: the autograd
    engine's thread runs a backward while its caller waits), `ids` its own
    ids over its parent's, times in ns of `time.time_ns()`."""

    name: str
    parent: Optional[str]
    ids: Dict[str, Any]
    thread: int
    start_ns: int
    end_ns: int


def _recording() -> bool:
    return torch.autograd._profiler_enabled() and not torch.compiler.is_compiling()


class _Span:
    __slots__ = ("name", "ids", "parent", "thread", "start_ns", "_function")

    def __init__(self, name: str, ids: Dict[str, Any]):
        self.name, self.ids = name, ids

    def open(self) -> None:
        self.thread = threading.get_ident()
        with _OPEN_LOCK:
            own = [s for s in _OPEN if s.thread == self.thread]
            parent = (own or _OPEN or [None])[-1]
            _OPEN.append(self)
        self.parent = parent.name if parent is not None else None
        if parent is not None:
            self.ids = {**parent.ids, **self.ids}
        self.start_ns = time.time_ns()
        args = ",".join(f"{k}={v}" for k, v in self.ids.items()) or None
        self._function = record_function(self.name, args)
        self._function.__enter__()

    def close(self) -> None:
        self._function.__exit__(None, None, None)
        end_ns = time.time_ns()
        with _OPEN_LOCK:
            _OPEN.remove(self)
        _LOG.append(SpanRecord(self.name, self.parent, self.ids, self.thread, self.start_ns,
                               end_ns))

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, exc_type, *_) -> None:
        if exc_type is not None:
            _forget_backward_spans_in(self)
        self.close()


def annotate(name: str, **ids):
    """The port's span `name` over the enclosed block (a context manager),
    with `ids` (a step, a call, the rows) added to its parent's. Recorded
    only while a profiler runs; otherwise one check and a shared null
    context."""
    if not _recording():
        return _NULL_SPAN
    return _Span(name, ids)


class _BackwardSpan(_Span):
    __slots__ = ("_pending",)

    def __init__(self, name: str, n_inputs: int):
        super().__init__(name, {})
        self._pending = n_inputs
        self.start_ns = None

    def opened(self, _grads) -> None:
        if self.start_ns is None:
            self.open()
            # a backward that computes no gradient for some input ends the
            # span with the pass
            torch.autograd.Variable._execution_engine.queue_callback(self.finished)

    def input_reached(self, _grad) -> None:
        self._pending -= 1
        if self._pending == 0:
            self.finished()

    def finished(self) -> None:
        if self.start_ns is not None and self._pending >= 0:
            self._pending = -1
            self.close()


def backward_span(name: str, inputs: Sequence[torch.Tensor],
                  outputs: Sequence[torch.Tensor]) -> None:
    """Span `<name>.backward` over the backward of the work from `inputs` to
    `outputs`: it opens when the first gradient reaches an output (a
    pre-hook on its node) and closes when the last input's gradient is
    complete (a hook on each input that requires one; tensor hooks run
    before node pre-hooks, so where one span's input is the next one's
    output the first closes before the second opens). The hooks return
    nothing, so gradients are unchanged. Added only while a profiler runs
    and gradients are on; otherwise the graph is left as it is. A pass that
    raises leaves the span unlogged once the port's span around it exits."""
    if not (_recording() and torch.is_grad_enabled()):
        return
    inputs = [t for t in inputs if t.requires_grad]
    outputs = [t for t in outputs if t.requires_grad]
    if not inputs or not outputs:
        return
    span = _BackwardSpan(f"{name}.backward", len(inputs))
    for t in outputs:
        if t.grad_fn is not None:
            t.grad_fn.register_prehook(span.opened)
        else:
            t.register_hook(span.opened)
    for t in inputs:
        t.register_hook(span.input_reached)


def _forget_backward_spans_in(span: _Span) -> None:
    """Drop, unlogged, the backward spans opened inside `span` that are
    still open as it exits by an exception: a pass that raised reaches
    neither their last input nor its end."""
    with _OPEN_LOCK:
        inside = _OPEN[_OPEN.index(span) + 1:]
        for s in inside:
            if isinstance(s, _BackwardSpan):
                s._pending = -1
                _OPEN.remove(s)


def spans() -> List[SpanRecord]:
    """The closed spans logged so far, oldest first."""
    return list(_LOG)


def clear_spans() -> None:
    _LOG.clear()


def _synchronize(out: Any) -> None:
    tensors = [out] if isinstance(out, torch.Tensor) else [
        x for x in (out if isinstance(out, (list, tuple)) else ()) if isinstance(x, torch.Tensor)]
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates per-step wall times around device work.

    >>> timer = StepTimer()
    >>> for _ in range(n):
    ...     with timer.step() as probe:
    ...         out = step(...)
    ...         probe(out)   # timing stops when out's device is idle
    >>> timer.summary()  # {"steps", "mean_s", "p50_s", "p90_s", "steps_per_sec"}
    """

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        holder: List[Any] = []
        start = time.perf_counter()
        yield holder.append
        if holder:
            _synchronize(holder[-1])
        self.times.append(time.perf_counter() - start)

    def summary(self, skip_warmup: int = 1) -> dict:
        if not self.times:
            raise ValueError("StepTimer.summary() called before any steps")
        times = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "steps": int(times.size),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p90_s": float(np.percentile(times, 90)),
            "steps_per_sec": float(1.0 / times.mean()),
        }


def _cuda_device(device) -> Optional[torch.device]:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def memory_stats(device=None) -> dict:
    """Device memory of `device` (default: the current CUDA device), in
    bytes: {"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "bytes_reserved"} from the caching allocator; {} on the CPU."""
    device = _cuda_device(device)
    if device is None:
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
    }


def live_array_bytes(device=None) -> int:
    """Bytes of live tensors the caching allocator holds on `device`
    (`allocated_bytes.all.current`); 0 on the CPU."""
    return memory_stats(device).get("bytes_in_use", 0)
