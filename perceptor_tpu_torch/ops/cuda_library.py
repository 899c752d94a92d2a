"""The port's hand-written CUDA kernels as one shared library.

Every source of `csrc/` (the flash-attention and GroupNorm kernels) is
compiled by nvcc for sm_90a and linked into one library in `build/`, named
after a hash of the sources and flags, at first use; the process loads it
once with ctypes. The op modules declare the argument types of their own C
entry points with `declare` and launch them through `launch` (or `call`),
which bind each entry point's types at its first call and raise on a
non-zero cudaError. Nothing here is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
_PREFIX = "libperceptor_kernels_"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers and spills go to the build report
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argument types of each C entry point, as the op modules declare them
_ARGTYPES = {}
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources(csrc: Path):
    return sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path(csrc: Path = _CSRC) -> Path:
    """Where `build_library` puts the library of these sources and flags:
    build/libperceptor_kernels_<hash of both>.so."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(csrc):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return _BUILD_DIR / f"{_PREFIX}{digest.hexdigest()[:12]}.so"


def build_library(csrc: Path = _CSRC) -> Path:
    """Compile every source under `csrc` (the package's csrc/ by default)
    for sm_90a (one nvcc per .cu file, all started together) and link them
    into one shared library in build/, once per version of the sources and
    flags; return its path. The compilers' reports (ptxas registers and
    spills per kernel) are kept beside it as `<library>.ptxas.txt`."""
    files = _sources(csrc)
    out = library_path(csrc)
    if out.exists():
        return out
    tag = out.stem.removeprefix(_PREFIX)
    nvcc = _nvcc()
    work = _BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in (f for f in files if f.suffix == ".cu"):
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            with open(log, "w") as sink:
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((src, obj, log, subprocess.Popen(cmd, stdout=sink, stderr=sink)))
        reports = []
        for src, _, log, proc in jobs:
            proc.wait()
            reports.append(f"== {src.name}\n{log.read_text()}")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{reports[-1][-8000:]}"
                )
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _, _ in jobs)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        out.with_suffix(".ptxas.txt").write_text("\n".join(reports))
        os.replace(tmp, out)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out


def declare(argtypes: dict) -> None:
    """Record the argument types of C entry points (name -> ctypes types);
    each returns an int cudaError. A name is declared once in a process."""
    again = _ARGTYPES.keys() & argtypes.keys()
    if again:
        raise ValueError(f"C entry points declared twice: {sorted(again)}")
    _ARGTYPES.update(argtypes)


def load_library(path: Optional[Path] = None) -> ctypes.CDLL:
    """The process's library, built and loaded at the first call; with
    `path`, the library `build_library` built there (a variant of the
    sources), loaded anew and used by the launches that follow."""
    global _lib
    with _lib_lock:
        if path is not None:
            _lib = ctypes.CDLL(str(path))
        elif _lib is None:
            _lib = ctypes.CDLL(str(build_library()))
        return _lib


def call(name: str, *args) -> None:
    """Call the C entry point `name`; raise on a non-zero cudaError."""
    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def launch(name: str, device: torch.device, *args) -> None:
    """`call` with `device` current and its current stream's handle as the
    last argument."""
    with torch.cuda.device(device):
        call(name, *args, torch.cuda.current_stream(device).cuda_stream)
