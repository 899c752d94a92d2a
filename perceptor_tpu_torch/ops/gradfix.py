"""`no_weight_gradients` (counterpart of perceptor_tpu/ops/gradfix.py), in
functional form: the tensors of a mapping or a sequence come back detached,
so no gradient reaches the weights. autograd differentiates convolutions to
any order, so StyleGAN's conv2d_gradfix needs no other counterpart."""

from __future__ import annotations

from typing import Mapping

import torch


def no_weight_gradients(params):
    """`params` (a tensor, or a mapping or sequence of them, nested) with
    every tensor detached."""
    if isinstance(params, torch.Tensor):
        return params.detach()
    if isinstance(params, Mapping):
        return {k: no_weight_gradients(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(no_weight_gradients(v) for v in params)
    return params
