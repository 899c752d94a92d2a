"""Differentiable ops (counterpart of perceptor_tpu/ops/__init__.py). The
functions are bound here at import, as the JAX package binds them: several
(`attention`, `bias_act`, `filtered_lrelu`, `resize`) share their
submodule's name, which a lazy export would let the submodule shadow. Take
such a submodule with `importlib.import_module("perceptor_tpu_torch.ops.attention")`:
`import perceptor_tpu_torch.ops.attention as m` binds the function.

`flash_attention` stays lazy, as in the JAX package; its module is
`flash_attention_kernel`, so no submodule shadows it."""

from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.bias_act import bias_act
from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.ops.conv2d_resample import conv2d_resample
from perceptor_tpu_torch.ops.deform_conv import deform_conv2d
from perceptor_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from perceptor_tpu_torch.ops.fma import fma
from perceptor_tpu_torch.ops.grid_sample import flow_warp, grid_sample
from perceptor_tpu_torch.ops.groupnorm import group_norm, group_norm_silu
from perceptor_tpu_torch.ops.resize import resize, resize_matrices
from perceptor_tpu_torch.ops.upfirdn import upfirdn2d
from perceptor_tpu_torch.ops.upsample_conv import upsample2x_nearest_conv3x3

__all__ = [
    "clamp_with_grad",
    "resize",
    "resize_matrices",
    "attention",
    "group_norm",
    "group_norm_silu",
    "bias_act",
    "upfirdn2d",
    "conv2d_resample",
    "fma",
    "filtered_lrelu",
    "deform_conv2d",
    "upsample2x_nearest_conv3x3",
    "grid_sample",
    "flow_warp",
    "flash_attention",
]


def __getattr__(name):
    if name == "flash_attention":
        from perceptor_tpu_torch.ops.flash_attention_kernel import flash_attention

        globals()[name] = flash_attention
        return flash_attention
    raise AttributeError(f"module 'perceptor_tpu_torch.ops' has no attribute {name!r}")
