"""Self-describing benchmark conditions (counterpart of
perceptor_tpu/utils/bench_env.py).

Every bench line carries the conditions it was measured under:

- ``loadavg`` and ``other_python_procs``: the host's 1/5/15-minute load and
  the other python processes, the usual contention on a shared host;
- ``build``: the flash-attention library's nvcc build (`build_kernels`):
  ``hit`` when build/ already held it, ``built`` when this process compiled
  it, with the seconds (JAX's compile-cache check has no counterpart);
- ``card``: `nvidia-smi`'s name and power limit of the card (a card set
  below its maximum power runs slower under load), the torch and CUDA
  versions, and whether `triton` imports;
- ``timestamp``: ISO-8601 UTC.
"""

from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import time
from typing import Optional

import torch


def _iter_python_procs():
    """(pid, cmdline) for every python process on the host."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        argv0 = cmd.split(" ", 1)[0]
        if "python" in os.path.basename(argv0):
            yield int(pid), cmd


def other_python_procs() -> int:
    """Concurrent python processes, this one excluded."""
    me = os.getpid()
    return sum(1 for pid, _ in _iter_python_procs() if pid != me)


def card() -> Optional[dict]:
    """{"name", "power_limit"} of CUDA device 0 as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, or None
    where there is no nvidia-smi."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, _, power = line.rpartition(",")
    return {"name": name.strip(), "power_limit": power.strip()}


def triton_imports() -> bool:
    try:
        importlib.import_module("triton")
    except ImportError:
        return False
    return True


def build_kernels() -> dict:
    """Build the flash-attention library if build/ does not hold it yet:
    {"library", "state": "hit" | "built", "seconds"}."""
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa

    path = fa.library_path()
    state = "hit" if path.exists() else "built"
    t0 = time.perf_counter()
    fa.build_library()
    return {"library": path.name, "state": state, "seconds": time.perf_counter() - t0}


def bench_env(build: Optional[dict] = None) -> dict:
    """The conditions dict embedded in every bench JSON line; `build` is
    `build_kernels()`'s record."""
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:  # pragma: no cover - getloadavg exists on linux
        load1 = load5 = load15 = -1.0
    env = {
        "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
        "loadavg": [load1, load5, load15],
        "other_python_procs": other_python_procs(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "triton": triton_imports(),
        "card": card(),
    }
    if build is not None:
        env["build"] = build
    return env
