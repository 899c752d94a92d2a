"""Device choice and seeded random initialization (counterpart of
perceptor_tpu/core/init.py).

The JAX package fills shape-traced parameter trees from a seeded numpy rng
(`init_by_shape`: weights normal with std 1/sqrt(fan_in), zero biases, unit
norm scales), so FLOPs and memory equal those of pretrained weights. Here
modules are built on the meta device, materialized on the target device and
filled from a seeded `torch.Generator` by the same rule.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU. A
    CUDA device on a machine without one raises; nothing falls back.

    Also turns TF32 off: fp32 matmuls (the antialiased resize) and
    convolutions run in full fp32, as the JAX code's `Precision.HIGHEST`;
    the bf16 model is unaffected. And it pins cuDNN to deterministic
    convolution algorithms: left free, cuDNN chose a nondeterministic one
    for the input gradient of fp32 convolutions (dpt_hybrid's ResNetV2
    trunk, under the depth loss), and a guided step must repeat bit for
    bit, as the JAX program does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return device


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill parameters like `init_by_shape`: weights ~ N(0, 1/fan_in), biases
    zero, 1-D norm weights one, scalars (CLIP's `logit_scale`) one standard
    normal draw. fan_in is the input size of a conv/linear weight (torch
    layout), else the product of all but the last dim (the flax layout of
    `proj` and `positional_embedding`). Buffers are no weights: a module
    that holds some fills them in its own `reset_buffers()` (BatchNorm
    statistics, fixed FIR taps)."""
    for submodule in module.modules():
        if hasattr(submodule, "reset_buffers"):
            submodule.reset_buffers()
    for name, param in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if param.ndim == 0:
            param.copy_(torch.randn((), generator=generator, device=param.device))
        elif "bias" in leaf:
            param.zero_()
        elif param.ndim == 1 and leaf == "weight":
            param.fill_(1.0)
        else:
            if leaf in ("weight", "in_proj_weight"):
                fan_in = param[0].numel()
            else:
                fan_in = int(np.prod(param.shape[:-1])) if param.ndim > 1 else param.shape[0]
            noise = torch.randn(
                param.shape, generator=generator, device=param.device, dtype=torch.float32
            )
            param.copy_(noise / float(np.sqrt(max(fan_in, 1))))
    return module


def random_module(cls, cfg, device, generator, dtype) -> nn.Module:
    """`cls(cfg)` on `device`, filled by `init_random_` from `generator`, its
    matmul weights stored in bf16 when `dtype` is the compute dtype, frozen
    and in eval mode."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to_empty(device=device)
    init_random_(module, generator)
    if dtype == COMPUTE_DTYPE:
        cast_matmul_params_bf16(module)
    return module.requires_grad_(False).eval()
