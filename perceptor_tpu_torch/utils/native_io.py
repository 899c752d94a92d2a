"""Native (C++) checkpoint IO with a pure-Python fallback (counterpart of
perceptor_tpu/utils/native_io.py).

A safetensors header (JSON) is parsed in Python; the tensor bytes are read
by the port's own `native/tensor_io.cpp` (mmap, MADV_SEQUENTIAL and a
multithreaded copy), built with g++ into the repository's `build/` at first
use (never at import) and bound with ctypes. Host IO, not a device kernel:
where g++ or the build fails, `read_span` reads in Python, and
`native_available()` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "tensor_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.uint16,  # raw bits, widened to fp32 below
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """build/libtensor_io_<hash of the source and flags>.so."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SOURCE.read_bytes())
    return _BUILD_DIR / f"libtensor_io_{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, out)


def _load_library() -> Optional[ctypes.CDLL]:
    """The native library, built once per version of the source; None (and
    `build_error()` set) when it cannot be built or loaded."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = f"{type(e).__name__}: {getattr(e, 'stderr', None) or e}"
            return None
        lib.pt_read_span.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong, ctypes.c_ulonglong,
                                     ctypes.c_void_p, ctypes.c_int]
        lib.pt_read_span.restype = ctypes.c_int
        lib.pt_file_size.argtypes = [ctypes.c_char_p]
        lib.pt_file_size.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether `read_span` reads natively (building the library if need be)."""
    return _load_library() is not None


def build_error() -> Optional[str]:
    """Why the native library did not build or load, or None."""
    _load_library()
    return _build_error


def read_span(path: str, offset: int, nbytes: int, n_threads: int = 8) -> np.ndarray:
    """file[offset:offset + nbytes] into a fresh byte buffer: natively when
    the library is available, else (or where the native read fails) in
    Python."""
    out = np.empty(nbytes, dtype=np.uint8)
    lib = _load_library()
    if lib is not None:
        status = lib.pt_read_span(str(path).encode(), offset, nbytes,
                                  out.ctypes.data_as(ctypes.c_void_p), n_threads)
        if status == 0:
            return out
    return read_span_python(path, offset, nbytes, out)


def read_span_python(path: str, offset: int, nbytes: int,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """`read_span`'s Python read."""
    out = np.empty(nbytes, dtype=np.uint8) if out is None else out
    with open(path, "rb") as f:
        f.seek(offset)
        f.readinto(memoryview(out))
    return out


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A safetensors file -> {name: numpy array}: the header in Python, each
    tensor's bytes through `read_span`; BF16 widened to fp32 exactly."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    base = 8 + header_len
    out: Dict[str, np.ndarray] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        begin, end = spec["data_offsets"]
        array = read_span(path, base + begin, end - begin).view(_DTYPES[spec["dtype"]])
        array = array.reshape(spec["shape"])
        if spec["dtype"] == "BF16":
            array = (array.astype(np.uint32) << 16).view(np.float32)
        out[name] = array
    return out
