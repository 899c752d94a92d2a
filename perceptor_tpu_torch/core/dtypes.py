"""Mixed-precision policy (counterpart of perceptor_tpu/core/dtypes.py).

`Policy` and its three presets are JAX's over torch dtypes.

Matmul and convolution weights (ndim >= 2) are stored in bf16; norm scales,
biases and scalars stay fp32. Every matmul/conv layer of the port computes
in its weight's dtype (`ops/layers.py`), so bf16 weight storage IS the bf16
compute policy: activations enter each layer cast to bf16, accumulate in
fp32 inside cuBLAS/cuDNN, and norms, softmax and schedule math run in fp32.
A module that lists names in its `fp32_params` keeps those parameters fp32:
the JAX code uses them uncast (BERT's embedding sum, the fp32 projection
heads of SLIP, BLIP and LiT).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch
import torch.utils._pytree as pytree
from torch import nn

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    @staticmethod
    def _cast(tree, dtype: torch.dtype):
        return pytree.tree_map(
            lambda x: x.to(dtype)
            if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
            tree,
        )

    def cast_to_compute(self, tree):
        """Every floating tensor of `tree` in the compute dtype."""
        return self._cast(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        """Every floating tensor of `tree` in the output dtype."""
        return self._cast(tree, self.output_dtype)


def default_policy() -> Policy:
    """bf16 compute, fp32 params and outputs."""
    return Policy()


def half_policy() -> Policy:
    """bf16 params and compute, fp32 outputs: frozen inference-only nets."""
    return Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  output_dtype=torch.float32)


def full_policy() -> Policy:
    """fp32 everywhere: parity runs."""
    return Policy(param_dtype=torch.float32, compute_dtype=torch.float32,
                  output_dtype=torch.float32)


def _is_matmul_weight(t: torch.Tensor) -> bool:
    return t.ndim >= 2 and t.is_floating_point()


def cast_matmul_params_bf16(
    obj: Union[nn.Module, Dict[str, torch.Tensor]],
) -> Union[nn.Module, Dict[str, torch.Tensor]]:
    """bf16 storage for matmul/conv/embedding weights (ndim >= 2).

    A module is cast in place and returned, but for the parameters each
    submodule names in its `fp32_params`; a state_dict is returned as a new
    dict. 1-D norm scales/biases and scalars stay fp32.
    """
    if isinstance(obj, nn.Module):
        with torch.no_grad():
            for module in obj.modules():
                keep = getattr(module, "fp32_params", ())
                for name, param in module.named_parameters(recurse=False):
                    if _is_matmul_weight(param) and name not in keep:
                        param.data = param.data.to(torch.bfloat16)
        return obj
    return {
        k: v.to(torch.bfloat16) if _is_matmul_weight(v) else v
        for k, v in obj.items()
    }


def keep_fp32(module: nn.Module) -> nn.Module:
    """Mark `module`'s `weight` to stay fp32 under `cast_matmul_params_bf16`;
    returns `module`."""
    module.fp32_params = ("weight",)
    return module
