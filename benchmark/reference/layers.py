"""Plain PyTorch layers of the reference networks.

Every product runs in float32 with TF32 off (`full_precision`). A layer can
instead compute as an fp8 product would (`set_fp8`): its input and weight
rounded to float8 e4m3 (the input per tensor, the weight per output
channel, each scaled to the format's range), the product accumulated in
float32, and the gradient reaching its output rounded to e5m2. That is the
control of the benchmark's comparison: the reference one precision below
the bf16 the configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ATTENTION_BLOCK_BYTES = 1 << 30  # the fp32 scores one attention block may hold


def full_precision() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dims=None, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """`x` rounded to the float8 `dtype` and back, scaled so that its
    largest magnitude (over all of it, or per index of the dims kept when
    `dims` names the reduced ones) maps to the format's largest value."""
    x = x.float()
    amax = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Fp8Gradient(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to
    float8 e5m2, as an fp8 product's input gradient would take it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad, dtype=torch.float8_e5m2)


class Fp8Mixin:
    """A product whose operands are rounded to fp8 when `fp8` is set (the
    input's gradient passes straight through its rounding)."""

    fp8 = False

    def _operands(self, x):
        if not self.fp8:
            return x, self.weight
        x = x + (fp8_round(x) - x).detach()
        return x, fp8_round(self.weight, tuple(range(1, self.weight.ndim)))

    def _output(self, y):
        return _Fp8Gradient.apply(y) if self.fp8 else y


class Linear(Fp8Mixin, nn.Linear):
    def forward(self, x):
        x, w = self._operands(x)
        return self._output(F.linear(x, w, self.bias))


class Conv2d(Fp8Mixin, nn.Conv2d):
    def forward(self, x):
        x, w = self._operands(x)
        return self._output(F.conv2d(x, w, self.bias, self.stride, self.padding))


def set_fp8(module: nn.Module, on: bool = True) -> nn.Module:
    """Make every Linear and Conv2d of `module` compute as fp8 products."""
    for m in module.modules():
        if isinstance(m, Fp8Mixin):
            m.fp8 = on
    return module


def group_norm(channels: int, eps: float, groups: int = 32) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, channels), channels, eps=eps)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, scale=None, mask=None):
    """softmax(q k^T scale + mask) v over (B, H, S, D), in blocks of query
    rows so that the scores stay under ATTENTION_BLOCK_BYTES."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    rows = max(1, ATTENTION_BLOCK_BYTES // (4 * b * h * sk))
    outs = []
    for start in range(0, sq, rows):
        scores = torch.matmul(q[:, :, start:start + rows], k.transpose(-1, -2)) * scale
        if mask is not None:
            scores = scores + mask[..., start:start + rows, :]
        outs.append(torch.matmul(torch.softmax(scores, dim=-1), v))
    return torch.cat(outs, dim=2)


def causal_mask(seq: int, device) -> torch.Tensor:
    """Additive (1, 1, S, S) mask: -inf above the diagonal."""
    return torch.triu(torch.full((seq, seq), float("-inf"), device=device), 1)[None, None]


def build(module_cls, cfg: dict, state: dict, fp8: bool = False) -> nn.Module:
    """`module_cls(cfg)` holding `state` upcast to float32, frozen; with
    `fp8`, its products computed as fp8 ones."""
    with torch.device("meta"):
        module = module_cls(cfg)
    module.load_state_dict({k: v.float() for k, v in state.items()}, assign=True)
    return set_fp8(module.requires_grad_(False).eval(), fp8)
