"""Differentiable image parameterizations (counterpart of
perceptor_tpu/drawers/__init__.py). A drawer of the JAX package that is not
ported yet raises an AttributeError that says so; ROADMAP.md queue A lists
the order in which they come."""

from perceptor_tpu_torch.drawers.brute_diffusion import BruteDiffusion
from perceptor_tpu_torch.drawers.deep_image_prior import DeepImagePrior
from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.drawers.jpeg import JPEG
from perceptor_tpu_torch.drawers.raw import Raw
from perceptor_tpu_torch.drawers.rudalle import BruteRuDalle

_NOT_PORTED = ("StyleGANXL",)

__all__ = ["DrawingInterface", "Raw", "JPEG", "BruteDiffusion", "DeepImagePrior", "BruteRuDalle"]


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"perceptor_tpu_torch.drawers.{name} is not ported yet (ROADMAP.md queue A)"
        )
    raise AttributeError(f"module 'perceptor_tpu_torch.drawers' has no attribute {name!r}")
