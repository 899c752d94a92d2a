"""[0,1] image space <-> [-1,1] diffusion x-space (counterpart of
perceptor_tpu/predictions/diffusion_space.py)."""

from __future__ import annotations


def encode(images):
    """[0,1] images -> [-1,1] xs."""
    return images * 2.0 - 1.0


def decode(xs):
    """[-1,1] xs -> [0,1] images."""
    return (xs + 1.0) / 2.0
