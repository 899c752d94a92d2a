#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the CUDA device(s) of
this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names its
configuration, its traffic mix and, in `benchmark/workloads/<cell>.json`,
its driver and the limits of its comparison. The run:

1. set-up: builds the program's kernels if the checkout's `build/` does not
   hold them yet (`build` in the result says which, with the seconds), has
   the driver draw the weights and inputs from `--seed` and build the
   program, and warms up the cell's own shapes;
2. the window: calls the program's entry, one call after another (a closed
   loop), for `--seconds`; a call that starts in the window runs to its
   end and counts whole;
3. with `--trace 1`, counts the FLOPs of one call and profiles a few more,
   and reads the per-layer metrics from them (`benchmark/metrics/`);
4. frees the program and compares what the window produced with the plain
   reference (`benchmark/reference/`), each measure beside its limit.

It prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` the
`breakdown`, and last `checks`; the checks also go, one a line, last to
standard error. It exits non-zero, printing no result, without as many
CUDA devices as the cell asks for, or if JAX or the JAX package was loaded.
Compile caches stay inside the checkout, under `build/`.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "perceptor_tpu"})
GIB = float(1 << 30)
BREAKDOWN_ENTRIES = 10


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def pin_caches() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN_MODULES)


def build_kernels(device) -> dict:
    """The program's flash library, built into `build/` unless there."""
    import torch

    if torch.device(device).type != "cuda":
        return {"state": "none", "seconds": 0.0}
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    state = "hit" if fa.library_path().exists() else "built"
    t0 = time.perf_counter()
    fa.build_library()
    return {"state": state, "seconds": time.perf_counter() - t0}


def cell_metrics(entries: list, cell: str) -> list:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def window(cell, seconds: float) -> tuple:
    """Calls until `seconds` have passed: (wall seconds, seconds of each
    call)."""
    cell.sampling = True
    times = []
    t0 = now = time.perf_counter()
    while now - t0 < seconds:
        start = now
        cell.call()
        now = time.perf_counter()
        times.append(now - start)
    cell.sampling = False
    return now - t0, times


def per_layer(cell, name: str, spec: dict, ms_per_step: float, device) -> tuple:
    """(per-layer metrics, device busy and window seconds, breakdown) of a
    traced stretch of the cell."""
    from benchmark.harness import device as card
    from benchmark.harness import flops, registry, trace

    ops = registry.attention_ops()
    counter = flops.count(cell.count_call, ops)
    n_calls = cell.mix["profile_calls"]
    traced = trace.profile(cell.call, n_calls, cell.spans, cell.spans.names | set(ops),
                           lambda: card.synchronize(device))
    attributed = sum(k[3] in traced.launch_at for k in traced.kernels)
    print(f"trace: {len(traced.kernels)} device ops, {attributed} matched to a host launch, "
          f"{traced.launches} launches, {len(traced.spans)} spans, {traced.wall_s:.3f} s",
          file=sys.stderr)
    peak_flops, peak_bytes = card.card_peaks(card.name(device))
    reading = trace.Reading(
        trace=traced, steps=n_calls * cell.steps_per_call, ms_per_step=ms_per_step,
        flops_per_step=counter.flops / cell.steps_per_call,
        attention_per_call=counter.attention, calls=n_calls, attention_ops=ops,
        peak_flops=peak_flops, peak_bytes=peak_bytes)
    metrics = {}
    for entry in cell_metrics(spec["per_layer"], name):
        value = registry.load_module("metrics", registry.quantity(entry["name"])).read(reading)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    start, end = traced.window
    times = {"busy_s": traced.busy_us() / 1e6, "window_s": (end - start) / 1e6}
    breakdown = {"device_ops": traced.top_ops(BREAKDOWN_ENTRIES),
                 "idle_gaps": traced.idle_gaps(BREAKDOWN_ENTRIES)}
    return metrics, times, breakdown


def run(name: str, seed: int, seconds: float, traced: bool, device="cuda", spec=None,
        cell_overrides=None) -> dict:
    """One run of cell `name`; returns the result line's object.
    `cell_overrides` replaces keys of the cell (the CPU tests' tiny
    configurations)."""
    import torch

    from benchmark.harness import compare, registry
    from benchmark.harness import device as card

    spec = spec or registry.benchmark_spec()
    entry = registry.cell_spec(name, spec)
    entry.update(cell_overrides or {})
    device = torch.device(device)
    parts = {"start_s": process_age_s()}
    build = build_kernels(device)
    t0 = time.perf_counter()
    driver = registry.load_module("drivers", entry["driver"])
    cell = driver.Cell(entry, seed, device)
    t1 = time.perf_counter()
    cell.warm_up()
    card.synchronize(device)
    gc.collect()
    card.reset_peak(device)
    parts.update(build_s=build["seconds"], program_s=t1 - t0, **cell.timings,
                 warm_up_s=time.perf_counter() - t1)
    setup_s = process_age_s()

    wall_s, times = window(cell, seconds)
    peak = card.peak_bytes(device)
    steps = len(times) * cell.steps_per_call
    ms_per_step = wall_s * 1e3 / steps
    step_ms = [t * 1e3 / cell.steps_per_call for t in times]
    values = {
        "ms_per_step": ms_per_step,
        "step_ms_p95": statistics.quantiles(step_ms, n=100, method="inclusive")[94]
        if len(step_ms) > 1 else step_ms[0],
        "peak_mem_gib": peak / GIB,
        "setup_s": setup_s,
    }
    result = {"correct": False, "attempted": len(times), "failed": 0}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": card.name(device),
                   "count": entry["chips"],
                   "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        metrics, times_info, breakdown = per_layer(cell, name, spec, ms_per_step, device)
        device_info.update(times_info)
    else:
        metrics = {m["name"]: {"value": values[registry.quantity(m["name"])], "unit": m["unit"]}
                   for m in cell_metrics(spec["end_to_end"], name)}
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        checks = compare.verdict(cell.measures(), entry["limits"])
    result.update(correct=compare.correct(checks), metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(build=build, setup_parts=parts,
                  window={"seconds": wall_s, "steps": steps, "calls": len(times)},
                  conditions=card.conditions() if device.type == "cuda" else {})
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    pin_caches()
    import torch

    from benchmark.harness import registry

    spec = registry.benchmark_spec()
    chips = registry.cell_spec(args.workload, spec)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", spec)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for check, c in result["checks"].items():
        print(f"check {check} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
