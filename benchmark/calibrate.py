#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the CUDA device.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds S] [--fault NAME]

For each of `--seeds`: the cell built from that seed, warmed up, a window
of `--seconds` at the cell's own load, and the comparison with the
reference (the program's readings, the lower ends of the limits). For each
of `--control-seeds`: the control, the reference computed with fp8
products and a bfloat16 sampler update in the program's place, held to the
float32 reference by the same measures (the upper ends). With `--fault`,
the program's runs have that fault of `benchmark/tests/faults.py` planted.
One JSON line per seed. The benchmark's runs do not run this; the limits in
`benchmark/workloads/<cell>.json` were set from its output (PERF.md).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_readings(driver, entry: dict, seed: int, seconds: float, device, kind: str):
    """The program's run from `seed`: warm-up, a window of `seconds`, the
    comparison; one JSON line."""
    import torch

    from benchmark import run

    t0 = time.perf_counter()
    cell = driver.Cell(entry, seed, device)
    cell.warm_up()
    wall_s, times = run.window(cell, seconds)
    steps = len(times) * cell.steps_per_call
    cell.release()
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        values = cell.measures()
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"kind": kind, "seed": seed, "values": values,
                      "ms_per_step": wall_s * 1e3 / steps,
                      "calls": len(times), "seconds": time.perf_counter() - t0}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--fault", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    run.pin_caches()
    import torch

    from benchmark.harness import registry

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    entry = registry.cell_spec(args.workload)
    driver = registry.load_module("drivers", entry["driver"])
    run.build_kernels(device)
    kind = f"fault:{args.fault}" if args.fault else "program"
    with contextlib.ExitStack() as stack:
        if args.fault:
            import pytest

            from benchmark.tests import faults

            faults.FAULTS[args.fault](stack.enter_context(pytest.MonkeyPatch.context()))
        for seed in (int(s) for s in args.seeds.split(",") if s):
            program_readings(driver, entry, seed, args.seconds, device, kind)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        values = driver.control_measures(entry, seed, device)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"kind": "control", "seed": seed, "values": values,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
