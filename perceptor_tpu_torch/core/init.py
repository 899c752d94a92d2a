"""Device choice and seeded random initialization (counterpart of
perceptor_tpu/core/init.py).

The JAX package fills shape-traced parameter trees from a seeded numpy rng
(`init_by_shape`: weights normal with std 1/sqrt(fan_in), zero biases, unit
norm scales), so FLOPs and memory equal those of pretrained weights. Here
modules are built on the meta device, materialized on the target device and
filled by the same rule: from a seeded `torch.Generator` by `init_random_`
(the models' weights), or from the seeded numpy rng itself by
`init_by_shape` / `init_on_cpu`, which take a module factory and give each
layer JAX's fan-in.
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


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._NormBase)


def fan_in(module: nn.Module, name: str, shape) -> int:
    """The fan-in JAX's `_fill` gives the same layer: flax stores a dense
    kernel (in, out), a conv kernel (kh, kw, in, out) and a transposed
    conv's (kh, kw, in, out), and takes the product of all but the last
    dim; torch stores them (out, in), (out, in, kh, kw) and
    (in, out, kh, kw). An embedding table is (num, dim) in both, so its
    fan-in is `num`, as in JAX. Any other tensor (a raw `nn.Parameter`) is
    taken in the flax layout."""
    shape = tuple(shape)
    if len(shape) <= 1:
        return int(shape[0]) if shape else 1
    if name == "weight" and isinstance(module, nn.modules.conv._ConvTransposeNd):
        return int(shape[0] * np.prod(shape[2:]))
    if name == "weight" and isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)):
        return int(np.prod(shape[1:]))
    return int(np.prod(shape[:-1]))


def _flax_layout(module: nn.Module, name: str, shape) -> tuple:
    """(the flax shape of a torch tensor, the permutation back to torch)."""
    n = len(shape)
    if name != "weight" or n < 2:
        return tuple(shape), tuple(range(n))
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        perm = (n - 2, n - 1, *range(n - 2))  # (in, out, k..) <- (k.., in, out)
        return tuple(shape[2:]) + (shape[0], shape[1]), perm
    if isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)):
        perm = (n - 1, n - 2, *range(n - 2))  # (out, in, k..) <- (k.., in, out)
        return tuple(shape[2:]) + (shape[1], shape[0]), perm
    return tuple(shape), tuple(range(n))


def _fill(module: nn.Module, name: str, tensor: torch.Tensor,
          rng: np.random.Generator) -> np.ndarray:
    """JAX's `_fill` rule on a torch layer's tensor: scalars N(0, 1),
    norm scales (a norm layer's 1-D `weight`, flax `scale`) and running
    variances 1, biases and running means 0, everything else a normal with
    std 1/sqrt(fan_in), drawn in the flax layout and permuted to torch's."""
    shape = tuple(tensor.shape)
    if not shape:
        return np.asarray(rng.normal(0.0, 1.0), dtype=np.float32)
    if ("scale" in name or name in ("var", "running_var")
            or (name == "weight" and isinstance(module, _NORMS))):
        return np.ones(shape, dtype=np.float32)
    if "bias" in name or name in ("mean", "running_mean"):
        return np.zeros(shape, dtype=np.float32)
    std = np.float32(1.0 / np.sqrt(max(fan_in(module, name, shape), 1)))
    flax_shape, perm = _flax_layout(module, name, shape)
    out = rng.standard_normal(size=flax_shape, dtype=np.float32) * std
    return np.ascontiguousarray(out.transpose(perm))


@torch.no_grad()
def init_by_shape(factory, *args, seed: int = 0, device="cpu", **kwargs) -> nn.Module:
    """`factory(*args, **kwargs)` built on the meta device (no storage, no
    initializer run), materialized on `device` and filled by JAX's
    `_fill` rule from `np.random.default_rng(seed)`, parameters in
    registration order; BatchNorm statistics by the same rule, other
    buffers by a module's own `reset_buffers()`. Returns the module."""
    with torch.device("meta"):
        module = factory(*args, **kwargs)
    module = module.to_empty(device=torch.device(device))
    rng = np.random.default_rng(seed)
    for submodule in module.modules():
        if hasattr(submodule, "reset_buffers"):
            submodule.reset_buffers()
        tensors = list(submodule.named_parameters(recurse=False))
        if isinstance(submodule, nn.modules.batchnorm._NormBase):
            tensors += [(n, b) for n, b in submodule.named_buffers(recurse=False)
                        if n in ("running_mean", "running_var")]
            if submodule.num_batches_tracked is not None:
                submodule.num_batches_tracked.zero_()
        for name, tensor in tensors:
            tensor.copy_(torch.from_numpy(_fill(submodule, name, tensor, rng)))
    return module


def init_on_cpu(factory, *args, **kwargs) -> nn.Module:
    """`init_by_shape` (JAX's backward-compatible alias)."""
    return init_by_shape(factory, *args, **kwargs)
