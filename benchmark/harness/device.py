"""The card: its peaks, the conditions a run met, and the few CUDA calls the
harness makes, which on the CPU (the tests' tiny runs) do nothing.

`card_peaks` gives NVIDIA's data-sheet dense bf16 FLOP/s and memory
bytes/s by card name. `conditions` records the card's name and power limit
(`nvidia-smi`; a card set below its maximum runs slower under load), the
host's load and other python processes, the torch and CUDA versions.
"""

from __future__ import annotations

import os
import subprocess

import torch


def card_peaks(name: str):
    """(dense bf16 FLOP/s, memory bytes/s) of the card named `name`; the
    H100 SXM's unless the name says otherwise."""
    upper = name.upper()
    if "H100" in upper and "PCIE" in upper:
        return 756e12, 2.0e12
    if "H100" in upper and "NVL" in upper:
        return 835e12, 3.9e12
    if "H200" in upper:
        return 989e12, 4.8e12
    return 989e12, 3.35e12


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def _nvidia_smi() -> dict:
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    card, _, power = line.rpartition(",")
    return {"name": card.strip(), "power_limit": power.strip()}


def _other_python_procs() -> int:
    count = 0
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv0 = f.read().split(b"\0", 1)[0].decode(errors="replace")
        except OSError:
            continue
        count += "python" in os.path.basename(argv0)
    return count


def conditions() -> dict:
    return {
        "card": _nvidia_smi(),
        "loadavg": list(os.getloadavg()),
        "other_python_procs": _other_python_procs(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
