"""Differentiable ops (counterpart of perceptor_tpu/ops/__init__.py). The
functions are bound here at import, as the JAX package binds them: several
share their submodule's name, which a lazy export would let the submodule
shadow."""

from perceptor_tpu_torch.ops.bias_act import bias_act
from perceptor_tpu_torch.ops.conv2d_resample import conv2d_resample
from perceptor_tpu_torch.ops.deform_conv import deform_conv2d
from perceptor_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from perceptor_tpu_torch.ops.fma import fma
from perceptor_tpu_torch.ops.grid_sample import flow_warp, grid_sample

__all__ = ["bias_act", "conv2d_resample", "deform_conv2d", "filtered_lrelu", "fma",
           "grid_sample", "flow_warp"]
