"""Flash attention: three hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the autograd.Function that joins them.

Counterpart of perceptor_tpu/ops/flash_attention_kernel.py (Pallas TPU):

    flash_forward  <- _forward / _fwd_kernel   (O and the row logsumexp)
    flash_dq       <- _backward / _bwd_dq_kernel
    flash_dkv      <- _backward / _bwd_dkv_kernel

Layout (batch, heads, seq, head_dim). The kernels live in `csrc/`:
`flash_mma.cu` holds the three bf16 kernels (mma.sync with the scores,
their gradients and the accumulators in registers), `flash_attention.cu`
the C interface and the fp32 kernels. Every source there is compiled by
nvcc for sm_90a into one library in `build/` at first use and loaded with
ctypes.
On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each wrapper counts its kernel launches in
`LAUNCHES`. `_TILES` is the one table of tile sizes: each launch passes its
(block_q, block_k) pair, and the C dispatch refuses a pair it has not
instantiated.

Backward: the two-kernel scheme of the JAX package. The residuals
(q, k, v, o, lse) let each kernel recompute p = exp(scale * q k^T - lse)
tile by tile; dq accumulates over K/V tiles, dk/dv over Q tiles, so no
atomics are needed and results are deterministic. delta = rowsum(o * do)
is computed in fp32 before the launches, as the JAX code does.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers and spills go to the build report
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_DIM = 512

# kernel launches per wrapper, reset by callers that need to prove a path
# went through the kernels
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ----------------------------------------------------------


def flash_forward_plain(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o = softmax(scale q k^T) v in q's dtype, lse (B, H, Sq) fp32.
    All arithmetic in fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _recompute_p_ds(q, k, v, do, lse, delta, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """dq = sum_kv ds k with ds = p * (do v^T - delta) * scale, in fp32."""
    _, ds = _recompute_p_ds(q, k, v, do, lse, delta, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """(dk, dv): dv = p^T do, dk = ds^T q, in fp32."""
    p, ds = _recompute_p_ds(q, k, v, do, lse, delta, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA library ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q, k, v, o, lse | B, H, Sq, Sk, D | strides | scale, is_f32, block_q,
    # block_k, stream
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_P, _F, _I, _I, _I, _P],
    # q, k, v, do, lse, delta, dq | ... same
    "flash_dq": [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I, _I, _P],
    # q, k, v, do, lse, delta, dk, dv | ... same
    "flash_dkv": [_P] * 8 + [_I] * 5 + [_P, _F, _I, _I, _I, _P],
    # kernel (0 fwd, 1 dq, 2 dkv), D, is_f32, block_q, block_k, int[5] out
    "flash_describe": [_I] * 5 + [_P],
}
DTYPES = (torch.bfloat16, torch.float32)

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the flash-attention kernels cannot be built")
    return found


def _sources(csrc: Path):
    return sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path(csrc: Path = _CSRC) -> Path:
    """Where `build_library` puts the library of these sources and flags:
    build/libflash_attention_<hash of both>.so."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(csrc):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return _BUILD_DIR / f"libflash_attention_{digest.hexdigest()[:12]}.so"


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
    tag = out.stem.removeprefix("libflash_attention_")
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


def load_library(path: Path) -> ctypes.CDLL:
    """A library that `build_library` built, with the C entry points'
    argument types set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(build_library())
    return _lib


def _check_cuda_inputs(named, seq_dims):
    """Device, dtype, shape and stride checks shared by the three kernels."""
    q = named[0][1]
    b, h, _, d = q.shape
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be a multiple of 8 and <= {MAX_HEAD_DIM}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the CUDA kernels take bfloat16 or float32, got {q.dtype}")
    for (name, t), seq in zip(named, seq_dims):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.shape != (b, h, seq, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {(b, h, seq, d)}")
        # 16-byte vector loads: unit stride over head_dim, other strides and
        # the base address 16-byte aligned
        if (
            t.stride(3) != 1
            or any(s * t.element_size() % 16 for s in t.stride()[:3])
            or t.data_ptr() % 16
        ):
            raise ValueError(f"{name}: unsupported strides {t.stride()} or alignment")


def _check_lse(name, t, shape, device):
    # the kernels copy lse and delta 16 bytes at a time
    if (
        t.device != device or t.dtype != torch.float32 or t.shape != shape
        or not t.is_contiguous() or t.data_ptr() % 16
    ):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 {shape} "
                         f"tensor on {device}")


def _strides(*tensors):
    """(batch, head, seq) element strides of up to four tensors, as the C
    array the kernels read (12 values, zero-filled)."""
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * 12)(*values, *([0] * (12 - len(values))))


def _raise_on_error(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# (block_q, block_k) of each kernel by dtype and head_dim: rows of (largest
# head_dim, tiles). The wrappers pass the pair to the C entry points, whose
# dispatch returns an error for a pair it has not instantiated.
_TILES = {
    (torch.bfloat16, "fwd"): ((48, (128, 64)), (128, (64, 64)), (512, (32, 32))),
    (torch.bfloat16, "dq"): ((48, (128, 64)), (128, (64, 64)), (512, (32, 32))),
    (torch.bfloat16, "dkv"): ((80, (64, 64)), (128, (32, 64)), (512, (32, 32))),
    (torch.float32, "fwd"): ((128, (32, 32)), (512, (16, 32))),
    (torch.float32, "dq"): ((128, (32, 32)), (512, (16, 16))),
    (torch.float32, "dkv"): ((128, (32, 32)), (512, (16, 16))),
}


def _kernel_blocks(d: int, kernel: str, dtype: torch.dtype):
    """(block_q, block_k) the CUDA kernel uses for this head_dim and dtype."""
    for max_d, blocks in _TILES[(dtype, kernel)]:
        if d <= max_d:
            return blocks
    raise ValueError(f"head_dim {d} above {MAX_HEAD_DIM}")


def _check_blocks(sq: int, sk: int, d: int, kernel: str, dtype: torch.dtype):
    """The kernel's (block_q, block_k), after checking that they divide the
    sequence lengths."""
    bq, bk = _kernel_blocks(d, kernel, dtype)
    if sq % bq or sk % bk:
        raise ValueError(
            f"sequence lengths ({sq}, {sk}) must be multiples of the {kernel} "
            f"kernel's blocks ({bq}, {bk})"
        )
    return bq, bk


_KERNEL_IDS = {"fwd": 0, "dq": 1, "dkv": 2}


def kernel_info(kernel: str, d: int, dtype: torch.dtype) -> dict:
    """Registers, local (spill and stack) bytes, dynamic shared bytes, threads
    and resident blocks per SM of the CUDA kernel that `kernel` ("fwd", "dq"
    or "dkv") runs at this head_dim and dtype, read from the CUDA runtime."""
    bq, bk = _kernel_blocks(d, kernel, dtype)
    info = (ctypes.c_int * 5)()
    err = _library().flash_describe(
        _KERNEL_IDS[kernel], d, dtype == torch.float32, bq, bk, info
    )
    _raise_on_error(f"flash_describe({kernel}, {d})", err)
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")
    return {"block_q": bq, "block_k": bk, **dict(zip(keys, info))}


# -- wrappers --------------------------------------------------------------


def _device_check(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_forward(q, k, v, scale: float):
    """(o, lse) for (B, H, S, D) inputs; lse is (B, H, Sq) fp32."""
    if not _device_check(q):
        return flash_forward_plain(q, k, v, scale)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_cuda_inputs([("q", q), ("k", k), ("v", v)], [sq, sk, sk])
    bq, bk = _check_blocks(sq, sk, d, "fwd", q.dtype)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, sq, sk, d, _strides(q, k, v), float(scale), q.dtype == torch.float32,
            bq, bk, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on_error("flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_checks(q, k, v, do, lse, delta, kernel):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_cuda_inputs([("q", q), ("k", k), ("v", v), ("do", do)], [sq, sk, sk, sq])
    _check_lse("lse", lse, (b, h, sq), q.device)
    _check_lse("delta", delta, (b, h, sq), q.device)
    bq, bk = _check_blocks(sq, sk, d, kernel, q.dtype)
    return b, h, sq, sk, d, bq, bk


def flash_dq(q, k, v, do, lse, delta, scale: float):
    """dq of softmax(scale q k^T) v given the forward's lse and
    delta = rowsum(o * do) in fp32."""
    if not _device_check(q):
        return flash_dq_plain(q, k, v, do, lse, delta, scale)
    b, h, sq, sk, d, bq, bk = _bwd_checks(q, k, v, do, lse, delta, "dq")
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d, _strides(q, k, v, do),
            float(scale), q.dtype == torch.float32, bq, bk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on_error("flash_dq", err)
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of softmax(scale q k^T) v, same inputs as `flash_dq`."""
    if not _device_check(q):
        return flash_dkv_plain(q, k, v, do, lse, delta, scale)
    b, h, sq, sk, d, bq, bk = _bwd_checks(q, k, v, do, lse, delta, "dkv")
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        err = _library().flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
            _strides(q, k, v, do), float(scale), q.dtype == torch.float32, bq, bk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on_error("flash_dkv", err)
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX `_flash` custom VJP: saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda and (
            do.stride(3) != 1 or any(s * do.element_size() % 16 for s in do.stride()[:3])
        ):
            do = do.contiguous()
        delta = (o.float() * do.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


HEAD_DIM_MULTIPLE = 8


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, S, D), differentiable; the flash
    kernels on CUDA tensors, their plain versions on CPU tensors.

    A head_dim that is no multiple of 8 (the kernels' 16-byte vector loads)
    is zero-padded up to one and the result sliced back, as the JAX wrapper
    pads to its lane width: zero columns add nothing to q k^T and give zero
    output columns, and autograd slices the gradients. `scale` defaults to
    1/sqrt of the true head_dim. What the kernels still cannot run (a
    head_dim above 512, fp16) raises on a CUDA tensor."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (batch, heads, seq, head_dim) tensors")
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pad = -d % HEAD_DIM_MULTIPLE
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out = _FlashAttention.apply(q, k, v, float(scale))
    return out[..., :d] if pad else out
