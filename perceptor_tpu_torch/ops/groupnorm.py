"""GroupNorm and fused GroupNorm + activation (counterpart of
perceptor_tpu/ops/groupnorm.py).

`group_norm` and `group_norm_silu` take JAX's arguments and layout
(`channel_axis`, default last) and return the input's dtype;
`group_norm_fp32` is the NCHW fp32 norm the port's models use.

`fused_group_norm_act` is a `torch.autograd.Function` that saves only
(x, scale, bias, mean, rstd) and recomputes the normalized activations in
the backward, with every statistic in fp32 — the same backward as the JAX
custom VJP `_fused_gn_act_bwd`. Its forward and backward are ops of the
`perceptor_tpu_torch` library (`::group_norm_act`,
`::group_norm_act_backward`): on a CUDA tensor each launches the
hand-written kernels of `csrc/groupnorm.cu` over NCHW memory (an input in
another layout is copied to it) or raises, and counts them in
`GN_LAUNCHES`; on a CPU tensor each is the plain fp32 PyTorch version
(`group_norm_act_plain`, `group_norm_act_backward_plain`); a fake
implementation gives tracing the shapes, so an exported program holds each
as one node. The port's spans `group_norm` and `group_norm.backward` cover
the forward and the backward calls.

The kernels replace no TPU kernel: JAX leaves GroupNorm to XLA, which fuses
it. They replace the plain chain on the card, which moved about 86 bytes per
element of a bf16 input in the forward and about 190 in the backward over
some 23 and 35 launches. They are bound by bytes at 3.35 TB/s: 6 bytes per
element forward (x read for the statistics, read again and the output
written), about 10 backward. A group's statistics are summed by several
blocks into a small fp32 workspace and folded by the next launch, so that
few large groups (the VAE's 32 groups of 2 MB at 512 x 512, batch 1) still
fill the card; `launch_shape` chooses that split from the shape alone.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.ops import cuda_library
from perceptor_tpu_torch.utils import profiling


def group_norm(
    x: torch.Tensor,
    num_groups: int = 32,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    channel_axis: int = -1,
) -> torch.Tensor:
    """GroupNorm over (..., C) or (N, C, ...) tensors, JAX's signature and
    arithmetic: statistics in fp32 per (batch, group) over all positions and
    the group's channels, the normalized values cast to `x`'s dtype, then
    the per-channel `scale` and `bias` applied in that dtype."""
    channel_axis = channel_axis % x.ndim
    c = x.shape[channel_axis]
    if c % num_groups:
        raise ValueError(f"{c} channels not divisible by {num_groups} groups")
    xt = x.movedim(channel_axis, -1)
    shape = xt.shape
    g32 = xt.reshape(shape[0], -1, num_groups, c // num_groups).float()
    mean = g32.mean(dim=(1, 3), keepdim=True)
    var = g32.var(dim=(1, 3), keepdim=True, unbiased=False)
    normed = ((g32 - mean) * torch.rsqrt(var + eps)).reshape(shape).to(x.dtype)
    if scale is not None:
        normed = normed * scale.to(x.dtype)
    if bias is not None:
        normed = normed + bias.to(x.dtype)
    return normed.movedim(-1, channel_axis)


def group_norm_silu(
    x: torch.Tensor,
    num_groups: int = 32,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    channel_axis: int = -1,
) -> torch.Tensor:
    """`group_norm` followed by SiLU (JAX `group_norm_silu`)."""
    h = group_norm(x, num_groups, scale, bias, eps, channel_axis)
    return h * torch.sigmoid(h)


def group_norm_fp32(x: torch.Tensor, weight, bias, num_groups: int, eps: float) -> torch.Tensor:
    """NCHW GroupNorm with fp32 statistics and fp32 output (flax
    `nn.GroupNorm(dtype=float32)`), the norm of `ops.layers.GroupNorm`."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)


# -- plain versions ----------------------------------------------------------


def _group_sum(per_channel: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(N, C) per-channel partials -> (N, G)."""
    n, c = per_channel.shape
    return per_channel.reshape(n, num_groups, c // num_groups).sum(dim=-1)


def _per_channel(per_group: torch.Tensor, c: int) -> torch.Tensor:
    """(N, G) -> (N, C, 1, 1), each group's value repeated over its channels."""
    n, g = per_group.shape
    return per_group.repeat_interleave(c // g, dim=1).reshape(n, c, 1, 1)


def _gn_stats(x: torch.Tensor, num_groups: int, eps: float):
    n, c, h, w = x.shape
    xf = x.float()
    m = (h * w) * (c // num_groups)
    mean = _group_sum(xf.sum(dim=(2, 3)), num_groups) / m
    var = _group_sum(torch.square(xf).sum(dim=(2, 3)), num_groups) / m - torch.square(mean)
    return mean, torch.rsqrt(var + eps)


def _affine_bc(v: torch.Tensor) -> torch.Tensor:
    """(C,) or (N, C) affine -> broadcastable (1|N, C, 1, 1) fp32."""
    v = v.float()
    if v.ndim == 1:
        return v[None, :, None, None]
    return v[:, :, None, None]


def _apply_act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return h * torch.sigmoid(h)
    if activation == "relu":
        return torch.clamp(h, min=0.0)
    if activation == "gelu":
        return F.gelu(h)
    if activation == "none":
        return h
    raise ValueError(f"unsupported activation {activation!r}")


def _act_grad(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        s = torch.sigmoid(h)
        return s * (1.0 + h * (1.0 - s))
    if activation == "relu":
        return (h > 0.0).to(h.dtype)
    if activation == "gelu":
        # d/dh [h * Phi(h)] = Phi(h) + h * phi(h)
        cdf = 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
        return cdf + h * torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
    if activation == "none":
        return torch.ones_like(h)
    raise ValueError(f"unsupported activation {activation!r}")


def group_norm_act_plain(x, scale, bias, num_groups: int, eps: float, out_dtype: torch.dtype,
                         activation: str):
    """(y, mean, rstd): y = act(group_norm(x) * scale + bias) in `out_dtype`,
    mean and rstd (N, G) fp32; all arithmetic in fp32."""
    mean, rstd = _gn_stats(x, num_groups, eps)
    c = x.shape[1]
    xhat = (x.float() - _per_channel(mean, c)) * _per_channel(rstd, c)
    h = xhat * _affine_bc(scale) + _affine_bc(bias)
    return _apply_act(h, activation).to(out_dtype), mean, rstd


def group_norm_act_backward_plain(dy, x, scale, bias, mean, rstd, activation: str):
    """(dx, dh_nc, dhx_nc): the input gradient in x's dtype, and the (N, C)
    fp32 sums over positions of dh and dh * xhat (dh the gradient at the
    affine's output), whose sums over the batch are the gradients of a (C,)
    bias and scale."""
    n, c, hh, ww = x.shape
    num_groups = mean.shape[1]
    m = hh * ww * (c // num_groups)

    rstd_c = _per_channel(rstd, c)
    xhat = (x.float() - _per_channel(mean, c)) * rstd_c
    h = xhat * _affine_bc(scale) + _affine_bc(bias)
    dh = dy.float() * _act_grad(h, activation)
    dxhat = dh * _affine_bc(scale)

    dh_nc = dh.sum(dim=(2, 3))  # (N, C)
    dhx_nc = (dh * xhat).sum(dim=(2, 3))  # (N, C)
    scale_f = scale.float()
    scale_f = scale_f[None] if scale_f.ndim == 1 else scale_f
    a_c = _per_channel(_group_sum(dh_nc * scale_f, num_groups) / m, c)
    b_c = _per_channel(_group_sum(dhx_nc * scale_f, num_groups) / m, c)
    dx = (rstd_c * (dxhat - a_c - xhat * b_c)).to(x.dtype)
    return dx, dh_nc, dhx_nc


# -- the CUDA kernels ----------------------------------------------------------

ACTIVATIONS = {"silu": 0, "relu": 1, "gelu": 2, "none": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VEC = 8  # elements a thread loads at once where H * W allows (16 bytes of bf16)
MAX_THREADS = 256
MAX_CHUNKS = 65535  # blocks per row: the grid's y dimension
# H100 SXM: 132 SMs of 2048 resident threads; a launch over a tensor large
# enough fills two waves of them
SMS = 132
THREADS_PER_SM = 2048
WAVES = 2
# the least work a thread gets from a split row, so that the split's fold and
# block reduction stay small beside the sweep
MIN_VECS_PER_THREAD = 2

# kernel launches, reset by callers that need to prove a path went through the
# kernels: per forward the statistics and the output, per backward the sums
# and dx
GN_LAUNCHES = {"gn_stats": 0, "gn_apply": 0, "gn_bwd_sums": 0, "gn_bwd_dx": 0}


def reset_launches() -> None:
    for name in GN_LAUNCHES:
        GN_LAUNCHES[name] = 0


def launch_shape(rows: int, hw: int, vec: int) -> Tuple[int, int, int]:
    """(threads, chunks, chunk_vecs) of a launch over `rows` (n, c) rows of
    `hw` elements read `vec` at a time: each row is split into `chunks`
    blocks of `threads` threads, block k taking vectors [k * chunk_vecs,
    min((k + 1) * chunk_vecs, hw // vec)), none empty. A row is split until
    the launch holds WAVES waves of the card's resident threads, or each
    thread is down to MIN_VECS_PER_THREAD vectors."""
    vecs = hw // vec
    threads = min(MAX_THREADS, -(-vecs // 32) * 32)
    wanted = -(-WAVES * SMS * THREADS_PER_SM // (threads * rows))
    most = max(1, vecs // (threads * MIN_VECS_PER_THREAD))
    chunks = max(1, min(wanted, most, MAX_CHUNKS))
    # at least `chunks` blocks, fewer than twice as many: wanted is at most
    # 16,896, so the count stays under MAX_CHUNKS
    chunk_vecs = vecs // chunks
    return threads, -(-vecs // chunk_vecs), chunk_vecs


def check_args(x_shape, x_dtype, scale_shape, bias_shape, num_groups: int,
               out_dtype: torch.dtype, activation: str) -> None:
    """Raises on what the kernels do not take: x (N, C, H, W) of float32,
    bfloat16 or float16 with C a multiple of num_groups, scale and bias (C,)
    or (N, C), a known activation and output dtype."""
    if len(x_shape) != 4:
        raise ValueError(f"the kernels take (N, C, H, W) inputs, got shape {tuple(x_shape)}")
    n, c, h, w = x_shape
    if n * c * h * w == 0:
        raise ValueError(f"empty input of shape {tuple(x_shape)}")
    if n * c >= 2**31 or h * w >= 2**31:
        raise ValueError(f"{n} x {c} rows of {h} x {w}: the kernels take fewer than 2**31 "
                         f"of each")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"{c} channels not divisible by {num_groups} groups")
    for name, dtype in (("x", x_dtype), ("out_dtype", out_dtype)):
        if dtype not in DTYPES:
            raise TypeError(f"{name}: the kernels take float32, bfloat16 or float16, got {dtype}")
    for name, shape in (("scale", scale_shape), ("bias", bias_shape)):
        if tuple(shape) not in ((c,), (n, c)):
            raise ValueError(f"{name} has shape {tuple(shape)}, want {(c,)} or {(n, c)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # x, scale, bias, y, mean, rstd, partial | N, C, HW, G, per_sample | eps |
    # act, x dtype, y dtype, vec, threads, chunks, chunk_vecs | stream
    "gn_forward": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 7 + [_P],
    # x, dy, scale, bias, mean, rstd, dx, dh_sum, dhx_sum, partial | N, C, HW,
    # G, per_sample, act, x dtype, dy dtype, vec, threads, chunks,
    # chunk_vecs | stream
    "gn_backward": [_P] * 10 + [_I] * 12 + [_P],
}
cuda_library.declare(_ARGTYPES)


def _check_devices(x, *others) -> None:
    for name, t in zip(("scale", "bias", "dy", "mean", "rstd"), others):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")


def _affine(scale, bias, n: int, c: int):
    """(scale, bias, per_sample): both contiguous fp32, (N, C) where either
    is (N, C), else (C,)."""
    per_sample = scale.ndim == 2 or bias.ndim == 2

    def prep(v):
        v = v.float()
        return (v.expand(n, c) if per_sample else v).contiguous()

    return prep(scale), prep(bias), per_sample


def _vec(hw: int, *tensors) -> int:
    """VEC where the rows hold whole vectors and every tensor's base address
    is aligned to one; else 1."""
    if hw % VEC == 0 and all(t.data_ptr() % (VEC * t.element_size()) == 0 for t in tensors):
        return VEC
    return 1


# -- the registered ops ------------------------------------------------------
#
# The forward and the backward are ops of the `perceptor_tpu_torch` library:
# the CUDA implementation launches the kernels and counts them, the CPU
# implementation is the plain version, the fake implementation gives the
# shapes to tracing (`torch.export`, FakeTensorMode). `_FusedGroupNormAct`
# joins them for autograd.


@torch.library.custom_op("perceptor_tpu_torch::group_norm_act", mutates_args=(),
                         device_types="cpu")
def _gn_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
           eps: float, out_dtype: torch.dtype,
           activation: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return group_norm_act_plain(x, scale, bias, num_groups, eps, out_dtype, activation)


@_gn_op.register_kernel("cuda")
def _gn_cuda(x, scale, bias, num_groups, eps, out_dtype, activation):
    check_args(x.shape, x.dtype, scale.shape, bias.shape, num_groups, out_dtype, activation)
    _check_devices(x, scale, bias)
    n, c, h, w = x.shape
    hw = h * w
    scale, bias, per_sample = _affine(scale, bias, n, c)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    x = x.contiguous()
    y = torch.empty((n, c, h, w), dtype=out_dtype, device=x.device)
    vec = _vec(hw, x, y)
    launch = (vec, *launch_shape(n * c, hw, vec))
    partial = torch.empty((n * c * launch[2] * 2,), dtype=torch.float32, device=x.device)
    cuda_library.launch(
        "gn_forward", x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(), n, c, hw, num_groups, per_sample,
        float(eps), ACTIVATIONS[activation], DTYPES[x.dtype], DTYPES[out_dtype], *launch,
    )
    GN_LAUNCHES["gn_stats"] += 1
    GN_LAUNCHES["gn_apply"] += 1
    return y, mean, rstd


def _like(x, dtype):
    """An output of x's shape in the layout the op gives it: NCHW from the
    kernels, x's own from the plain version."""
    if x.device.type == "cuda":
        return x.new_empty(x.shape, dtype=dtype)
    return torch.empty_like(x, dtype=dtype)


@_gn_op.register_fake
def _(x, scale, bias, num_groups, eps, out_dtype, activation):
    n, c = x.shape[:2]
    stats = x.new_empty((n, num_groups), dtype=torch.float32)
    return _like(x, out_dtype), stats, torch.empty_like(stats)


@torch.library.custom_op("perceptor_tpu_torch::group_norm_act_backward", mutates_args=(),
                         device_types="cpu")
def _gn_bwd_op(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, rstd: torch.Tensor,
               activation: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return group_norm_act_backward_plain(dy, x, scale, bias, mean, rstd, activation)


@_gn_bwd_op.register_kernel("cuda")
def _gn_bwd_cuda(dy, x, scale, bias, mean, rstd, activation):
    n, c, h, w = x.shape
    num_groups = mean.shape[1]
    check_args(x.shape, x.dtype, scale.shape, bias.shape, num_groups, dy.dtype, activation)
    _check_devices(x, scale, bias, dy, mean, rstd)
    if dy.shape != x.shape:
        raise ValueError(f"dy has shape {tuple(dy.shape)}, x {tuple(x.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (n, num_groups):
            raise ValueError(f"{name} must be float32 of shape {(n, num_groups)}")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    hw = h * w
    scale, bias, per_sample = _affine(scale, bias, n, c)
    dh_sum = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dhx_sum = torch.empty_like(dh_sum)
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device)
    vec = _vec(hw, x, dy, dx)
    launch = (vec, *launch_shape(n * c, hw, vec))
    partial = torch.empty((n * c * launch[2] * 2,), dtype=torch.float32, device=x.device)
    cuda_library.launch(
        "gn_backward", x.device, x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dh_sum.data_ptr(), dhx_sum.data_ptr(),
        partial.data_ptr(), n, c, hw, num_groups, per_sample, ACTIVATIONS[activation],
        DTYPES[x.dtype], DTYPES[dy.dtype], *launch,
    )
    GN_LAUNCHES["gn_bwd_sums"] += 1
    GN_LAUNCHES["gn_bwd_dx"] += 1
    return dx, dh_sum, dhx_sum


@_gn_bwd_op.register_fake
def _(dy, x, scale, bias, mean, rstd, activation):
    n, c = x.shape[:2]
    sums = x.new_empty((n, c), dtype=torch.float32)
    return _like(x, x.dtype), sums, torch.empty_like(sums)


class _FusedGroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, out_dtype, activation):
        y, mean, rstd = _gn_op(x, scale, bias, num_groups, eps, out_dtype, activation)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        with profiling.annotate("group_norm.backward", rows=x.shape[0]):
            dx, dh_nc, dhx_nc = _gn_bwd_op(dy, x, scale, bias, mean, rstd, ctx.activation)
        dscale = dbias = None
        if ctx.needs_input_grad[1]:
            dscale = (dhx_nc.sum(dim=0) if scale.ndim == 1 else dhx_nc).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = (dh_nc.sum(dim=0) if bias.ndim == 1 else dh_nc).to(bias.dtype)
        return dx, dscale, dbias, None, None, None, None


def fused_group_norm_act(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    out_dtype: Optional[torch.dtype] = None,
    activation: str = "silu",
) -> torch.Tensor:
    """act(group_norm(x) * scale + bias) over NCHW, fp32 statistics.

    `scale`/`bias` are per-channel (C,) or per-sample (N, C); `activation`
    is "silu" | "relu" | "gelu" (exact) | "none". Output in `out_dtype`
    (default: x.dtype). The kernels on a CUDA tensor, the plain version on
    a CPU tensor; the port's spans `group_norm` and `group_norm.backward`
    cover the forward and the backward.
    """
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels not divisible by {num_groups} groups")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    with profiling.annotate("group_norm", rows=x.shape[0]):
        return _FusedGroupNormAct.apply(x, scale, bias, num_groups, float(eps),
                                        out_dtype or x.dtype, activation)


class GroupNormSiLU(nn.Module):
    """GroupNorm(min(32, C) groups) + SiLU with the fused backward; param
    names (weight, bias) follow torch.nn.GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps)


class ScaleShiftGroupNormSiLU(nn.Module):
    """silu(group_norm(x) * (1 + scale) + shift) with scale/shift (N, C) from
    a conditioning embedding: ADM's `use_scale_shift_norm`, as one fused op.
    The learned GroupNorm affine and the embedding's fold into one (N, C)
    pair; param names (weight, bias) follow torch.nn.GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-5, num_groups: int = 32,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups = min(num_groups, channels)
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, scale_nc: torch.Tensor, shift_nc: torch.Tensor):
        one_plus = 1.0 + scale_nc.float()
        a = self.weight.float()[None] * one_plus
        b = self.bias.float()[None] * one_plus + shift_nc.float()
        return fused_group_norm_act(x, a, b, self.num_groups, self.eps, self.out_dtype)
