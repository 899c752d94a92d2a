"""Where the benchmark's pieces are found, by the names in BENCHMARK.json.

- a cell's workload file: `benchmark/workloads/<cell>.json` (its driver,
  the limits of its comparison);
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a configuration: the `file` of its entry in BENCHMARK.json;
- an entry driver: `benchmark/drivers/<driver>.py`;
- a per-layer metric's reader: `benchmark/metrics/<metric>.py`, where a
  metric named `<quantity>.<kind>` (one quantity split by the end-to-end
  metric it moves) is read by `<quantity>.py`;
- attention implementations: every `benchmark/attention_ops/*.json`.

A later cell, mix, configuration, driver, metric or attention
implementation is a new file and a new entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str, spec: dict = None) -> dict:
    """The BENCHMARK.json entry of cell `name`, with its workload file's
    keys, its traffic mix (`mix`) and its configuration (`config_data`)."""
    spec = spec or benchmark_spec()
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    cell = dict(entries[name])
    cell.update(load_json(BENCH_DIR / "workloads" / f"{name}.json"))
    cell["mix"] = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    configs = {c["name"]: c for c in spec["configs"]}
    cell["config_data"] = load_json(ROOT / configs[cell["config"]]["file"])
    return cell


def load_module(kind: str, name: str):
    """The module `benchmark/<kind>/<name>.py`."""
    path = BENCH_DIR / kind / f"{name}.py"
    module_spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def quantity(metric: str) -> str:
    """The quantity a metric reads: its name up to the first dot. An
    end-to-end `ms_per_step.device_bound` is `ms_per_step` in the cells it
    lists; a per-layer `mfu.device_bound` is read by `metrics/mfu.py`."""
    return metric.split(".", 1)[0]


def attention_ops() -> dict:
    """{op name: {"flops_per_bhqkd": n}} over every attention
    implementation's file."""
    ops = {}
    for path in sorted((BENCH_DIR / "attention_ops").glob("*.json")):
        ops.update(load_json(path)["ops"])
    return ops
