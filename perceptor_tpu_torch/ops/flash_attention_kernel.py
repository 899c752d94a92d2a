"""Flash attention: three hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the registered ops that join them.

Counterpart of perceptor_tpu/ops/flash_attention_kernel.py (Pallas TPU):

    flash_forward  <- _forward / _fwd_kernel   (O and the row logsumexp)
    flash_dq       <- _backward / _bwd_dq_kernel
    flash_dkv      <- _backward / _bwd_dkv_kernel

Layout (batch, heads, seq, head_dim). The kernels live in `csrc/`:
`flash_wgmma.cu` holds the bf16 forward up to head_dim 128 (TMA loads,
wgmma products, two consumer warpgroups whose softmax and products
overlap), `flash_mma.cu` the bf16 forward at head_dim 512 and the two bf16
backward kernels (mma.sync with the scores, their gradients and the
accumulators in registers), `flash_attention.cu` the C interface and the
fp32 kernels. `ops/cuda_library.py` builds them, with the GroupNorm
kernels, into the one library that both op modules call.

Each kernel is an op of the `perceptor_tpu_torch` library
(`torch.library.custom_op`: `perceptor_tpu_torch::flash_fwd`, `::flash_dq`,
`::flash_dkv`): on a CUDA tensor its CUDA implementation launches the kernel
(or raises) and counts the launch in `LAUNCHES`; on a CPU tensor its CPU
implementation is the plain version; a fake implementation gives tracing
the output shapes, and `register_autograd` joins the forward to the two
backward ops. So `torch.export` keeps each kernel as one node of its graph,
and a loaded program counts its launches as the eager path does. `_TILES`
is the one table of tile sizes: each launch passes its (block_q, block_k)
pair, and the C dispatch, which picks a kernel by head_dim, refuses a pair
that is not that kernel's.

Backward: the two-kernel scheme of the JAX package. The residuals
(q, k, v, o, lse) let each kernel recompute p = exp(scale * q k^T - lse)
tile by tile; dq accumulates over K/V tiles, dk/dv over Q tiles, so no
atomics are needed and results are deterministic. delta = rowsum(o * do)
is computed in fp32 before the launches, as the JAX code does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from perceptor_tpu_torch.ops import cuda_library
# benchmark/run.py builds the library through this module
from perceptor_tpu_torch.ops.cuda_library import build_library, library_path  # noqa: F401

MAX_HEAD_DIM = 512

# kernel launches per wrapper, reset by callers that need to prove a path
# went through the kernels
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# the forward's launches by design: bf16 on `flash_wgmma.cu` or on
# `flash_mma.cu`, and the fp32 kernel; they sum to LAUNCHES["flash_fwd"]
FWD_DESIGN_LAUNCHES = {"wgmma": 0, "mma": 0, "fp32": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FWD_DESIGN_LAUNCHES):
        for name in counts:
            counts[name] = 0


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


# -- the CUDA entry points ---------------------------------------------------

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
cuda_library.declare(_ARGTYPES)
DTYPES = (torch.bfloat16, torch.float32)


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


# (block_q, block_k) of each kernel by dtype and head_dim: rows of (largest
# head_dim, tiles). The wrappers pass the pair to the C entry points, whose
# dispatch picks the kernel by head_dim and returns an error for a pair that
# is not that kernel's. The bf16 forward up to head_dim 128 runs the Hopper
# design (`flash_wgmma.cu`, head_dim padded to 64 or 128): on an H100 it ran
# in 0.38-0.66 of the mma.sync forward's time at every site of the main
# paths (d = 32 and 40 padded to 64, 64, 80 padded to 128). The mma.sync
# forward (`flash_mma.cu`) runs d = 512.
WGMMA_FWD_BLOCKS = (128, 128)
_TILES = {
    (torch.bfloat16, "fwd"): ((128, WGMMA_FWD_BLOCKS), (512, (32, 32))),
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


def fwd_design(d: int, dtype: torch.dtype) -> str:
    """The key of FWD_DESIGN_LAUNCHES that a forward launch at this head_dim
    and dtype counts under."""
    if dtype == torch.float32:
        return "fp32"
    # the first row of the bf16 forward's tiles is the Hopper design's
    return "wgmma" if d <= _TILES[(dtype, "fwd")][0][0] else "mma"


_KERNEL_IDS = {"fwd": 0, "dq": 1, "dkv": 2}


def kernel_info(kernel: str, d: int, dtype: torch.dtype) -> dict:
    """Registers, local (spill and stack) bytes, dynamic shared bytes, threads
    and resident blocks per SM of the CUDA kernel that `kernel` ("fwd", "dq"
    or "dkv") runs at this head_dim and dtype, read from the CUDA runtime."""
    bq, bk = _kernel_blocks(d, kernel, dtype)
    info = (ctypes.c_int * 5)()
    cuda_library.call("flash_describe", _KERNEL_IDS[kernel], d, dtype == torch.float32, bq, bk,
                      info)
    keys = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")
    return {"block_q": bq, "block_k": bk, **dict(zip(keys, info))}


# -- the registered ops ----------------------------------------------------
#
# The three kernels are ops of the `perceptor_tpu_torch` library
# (`torch.library.custom_op`): the CUDA implementation launches the kernel
# and counts the launch, the CPU implementation is the plain version, the
# fake implementation gives the output shapes to tracing (`torch.export`,
# FakeTensorMode), and `register_autograd` joins forward and backward. So an
# exported program holds each kernel as one graph node, and a loaded program
# counts its launches in `LAUNCHES` like the eager path. A process that loads
# such a program must import `perceptor_tpu_torch` first, which registers
# the ops.


@torch.library.custom_op("perceptor_tpu_torch::flash_fwd", mutates_args=(), device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_forward_plain(q, k, v, scale)


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, scale):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_cuda_inputs([("q", q), ("k", k), ("v", v)], [sq, sk, sk])
    blocks = _check_blocks(sq, sk, d, "fwd", q.dtype)
    design = fwd_design(d, q.dtype)
    if design == "wgmma":
        # the tensor maps take no zero stride over more than one element
        q, k, v = (t if all(st or n == 1 for st, n in zip(t.stride(), t.shape))
                   else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    cuda_library.launch(
        "flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, _strides(q, k, v), float(scale),
        q.dtype == torch.float32, *blocks,
    )
    LAUNCHES["flash_fwd"] += 1
    FWD_DESIGN_LAUNCHES[design] += 1
    return o, lse


@_flash_fwd_op.register_fake
def _(q, k, v, scale):
    b, h, sq, d = q.shape
    return q.new_empty((b, h, sq, d)), q.new_empty((b, h, sq), dtype=torch.float32)


def _bwd_checks(q, k, v, do, lse, delta, kernel):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_cuda_inputs([("q", q), ("k", k), ("v", v), ("do", do)], [sq, sk, sk, sq])
    _check_lse("lse", lse, (b, h, sq), q.device)
    _check_lse("delta", delta, (b, h, sq), q.device)
    bq, bk = _check_blocks(sq, sk, d, kernel, q.dtype)
    return b, h, sq, sk, d, bq, bk


@torch.library.custom_op("perceptor_tpu_torch::flash_dq", mutates_args=(), device_types="cpu")
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                 lse: torch.Tensor, delta: torch.Tensor, scale: float) -> torch.Tensor:
    return flash_dq_plain(q, k, v, do, lse, delta, scale)


@_flash_dq_op.register_kernel("cuda")
def _flash_dq_cuda(q, k, v, do, lse, delta, scale):
    b, h, sq, sk, d, bq, bk = _bwd_checks(q, k, v, do, lse, delta, "dq")
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    cuda_library.launch(
        "flash_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d,
        _strides(q, k, v, do), float(scale), q.dtype == torch.float32, bq, bk,
    )
    LAUNCHES["flash_dq"] += 1
    return dq


@_flash_dq_op.register_fake
def _(q, k, v, do, lse, delta, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("perceptor_tpu_torch::flash_dkv", mutates_args=(), device_types="cpu")
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_dkv_plain(q, k, v, do, lse, delta, scale)


@_flash_dkv_op.register_kernel("cuda")
def _flash_dkv_cuda(q, k, v, do, lse, delta, scale):
    b, h, sq, sk, d, bq, bk = _bwd_checks(q, k, v, do, lse, delta, "dkv")
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=v.device)
    cuda_library.launch(
        "flash_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d,
        _strides(q, k, v, do), float(scale), q.dtype == torch.float32, bq, bk,
    )
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


@_flash_dkv_op.register_fake
def _(q, k, v, do, lse, delta, scale):
    return (torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


def _setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale


def _backward(ctx, do, _dlse):
    """The JAX `_flash` custom VJP's backward: delta = rowsum(o * do) in
    fp32, then dq and (dk, dv); lse takes no gradient."""
    q, k, v, o, lse = ctx.saved_tensors
    if do.is_cuda and (
        do.stride(3) != 1 or any(s * do.element_size() % 16 for s in do.stride()[:3])
    ):
        do = do.contiguous()
    delta = (o.float() * do.float()).sum(dim=-1)
    dq = _flash_dq_op(q, k, v, do, lse, delta, ctx.scale)
    dk, dv = _flash_dkv_op(q, k, v, do, lse, delta, ctx.scale)
    return dq, dk, dv, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def _device_check(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_forward(q, k, v, scale: float):
    """(o, lse) for (B, H, S, D) inputs; lse is (B, H, Sq) fp32. The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _device_check(q)
    return _flash_fwd_op(q, k, v, float(scale))


def flash_dq(q, k, v, do, lse, delta, scale: float):
    """dq of softmax(scale q k^T) v given the forward's lse and
    delta = rowsum(o * do) in fp32."""
    _device_check(q)
    return _flash_dq_op(q, k, v, do, lse, delta, float(scale))


def flash_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of softmax(scale q k^T) v, same inputs as `flash_dq`."""
    _device_check(q)
    return _flash_dkv_op(q, k, v, do, lse, delta, float(scale))


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
    out = flash_forward(q, k, v, float(scale))[0]  # differentiable: the op's autograd
    return out[..., :d] if pad else out
