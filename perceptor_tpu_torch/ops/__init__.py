"""Differentiable ops (counterpart of perceptor_tpu/ops/__init__.py). The
submodules are imported where they are used; `deform_conv2d` is bound here,
as the JAX package binds it."""

from perceptor_tpu_torch.ops.deform_conv import deform_conv2d

__all__ = ["deform_conv2d"]
