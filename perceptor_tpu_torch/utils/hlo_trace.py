"""Per-op device timings from a `torch.profiler` Chrome trace (counterpart
of perceptor_tpu/utils/hlo_trace.py, which reads `jax.profiler` traces).

`utils.profiling.trace(logdir)` writes the trace; `load_ops(logdir)`
reads the newest one under `logdir` into one event per device activity
(the "kernel", "gpu_memcpy" and "gpu_memset" events; a CPU-only run has
none, and then its "cpu_op" events are taken), each with the name of the
op that launched it as `long_name` (linked by the trace's correlation id)
and the FLOPs the profiler counted for that op (`with_flops=True`), and
`print_rollup` sums them by category and by subsystem::

    with profiling.trace(logdir):
        run_step()
    print_rollup(load_ops(logdir), subsystems={"unet": "unet", ...})
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class OpEvent:
    name: str
    duration_ms: float
    category: str
    long_name: str
    model_flops: int
    bytes_accessed: int


def _find_trace(logdir: str) -> Optional[str]:
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def load_ops(logdir: str) -> List[OpEvent]:
    """The device events of the most recent trace under `logdir` (its CPU
    ops where it holds none)."""
    path = _find_trace(logdir)
    if path is None:
        raise FileNotFoundError(f"no trace .json under {logdir}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [ev for ev in json.load(f).get("traceEvents", []) if ev.get("ph") == "X"]
    launched = {}
    for ev in events:
        if ev.get("cat") == "cpu_op":
            launched[(ev.get("args") or {}).get("External id")] = ev
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATEGORIES]
    chosen = device or [ev for ev in events if ev.get("cat") == "cpu_op"]
    ops = []
    for ev in chosen:
        args = ev.get("args") or {}
        op = launched.get(args.get("External id"), ev)
        ops.append(OpEvent(
            name=ev.get("name", ""),
            duration_ms=ev.get("dur", 0.0) / 1e3,
            category=ev.get("cat", "?"),
            long_name=op.get("name", ""),
            model_flops=int((op.get("args") or {}).get("flops", 0) or 0),
            bytes_accessed=0,
        ))
    return ops


def rollup(ops: List[OpEvent], subsystems: Optional[Dict[str, str]] = None):
    """-> (total_ms, by_category, by_subsystem) where subsystems maps
    label -> substring matched against the op's long_name or name."""
    by_cat = defaultdict(float)
    by_sub = defaultdict(float)
    total = 0.0
    for op in ops:
        total += op.duration_ms
        by_cat[op.category] += op.duration_ms
        label = "other"
        for sub, pat in (subsystems or {}).items():
            if pat in op.long_name or pat in op.name:
                label = sub
                break
        by_sub[label] += op.duration_ms
    return total, dict(by_cat), dict(by_sub)


def print_rollup(
    ops: List[OpEvent],
    subsystems: Optional[Dict[str, str]] = None,
    top: int = 20,
    peak_tflops: float = 989.0,
):
    """Totals, by category, by subsystem and the top ops; `peak_tflops`
    defaults to one H100 SXM's dense bf16 rate."""
    total, by_cat, by_sub = rollup(ops, subsystems)
    flops = sum(op.model_flops for op in ops)
    print(f"device total: {total:.2f} ms, {flops/1e12:.3f} model TFLOP "
          f"-> {flops/1e9/max(total,1e-9):.1f} TFLOP/s "
          f"({100*flops/1e9/max(total,1e-9)/peak_tflops:.1f}% of "
          f"{peak_tflops:.0f} TF/s peak)")
    print("\nby category:")
    for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {k:28s} {v:8.2f} ms")
    if subsystems:
        print("\nby subsystem:")
        for k, v in sorted(by_sub.items(), key=lambda kv: -kv[1]):
            print(f"  {k:28s} {v:8.2f} ms")
    print(f"\ntop {top} ops (ms, TFLOP/s):")
    for op in sorted(ops, key=lambda o: -o.duration_ms)[:top]:
        tfs = op.model_flops / op.duration_ms / 1e9 if op.duration_ms else 0
        print(f"  {op.duration_ms:8.3f}  {tfs:7.1f}  {op.name[:40]:40s} {op.long_name[:90]}")
