"""Runtime observability (counterpart of perceptor_tpu/utils/profiling.py):

  - `trace(logdir)`: `torch.profiler` over the enclosed block, host and
    device activity, written to `logdir` as a Chrome trace;
  - `annotate(name)`: a named span in that trace
    (`torch.profiler.record_function`);
  - `StepTimer`: wall time per step, ended by a device synchronize on the
    probed tensor's device, with the JAX summary's keys;
  - `memory_stats()` / `live_array_bytes()`: the CUDA caching allocator's
    occupancy under JAX's key names, `{}` / 0 on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, List, Optional

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


def annotate(name: str):
    """Label a region inside a profiler trace (a context manager)."""
    return record_function(name)


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
