"""Differentiable image parameterizations (counterpart of
perceptor_tpu/drawers/__init__.py). A drawer of the JAX package that is not
ported yet raises an AttributeError that says so; ROADMAP.md queue A item
10 lists the order in which they come."""

from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.drawers.jpeg import JPEG
from perceptor_tpu_torch.drawers.raw import Raw

_NOT_PORTED = ("BruteDiffusion", "DeepImagePrior", "BruteRuDalle", "StyleGANXL")

__all__ = ["DrawingInterface", "Raw", "JPEG"]


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"perceptor_tpu_torch.drawers.{name} is not ported yet (ROADMAP.md queue A item 10)"
        )
    raise AttributeError(f"module 'perceptor_tpu_torch.drawers' has no attribute {name!r}")
