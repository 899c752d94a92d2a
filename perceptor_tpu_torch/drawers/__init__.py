"""Differentiable image parameterizations (counterpart of
perceptor_tpu/drawers/__init__.py): every drawer of the JAX package."""

from perceptor_tpu_torch.drawers.brute_diffusion import BruteDiffusion
from perceptor_tpu_torch.drawers.deep_image_prior import DeepImagePrior
from perceptor_tpu_torch.drawers.interface import DrawingInterface
from perceptor_tpu_torch.drawers.jpeg import JPEG
from perceptor_tpu_torch.drawers.raw import Raw
from perceptor_tpu_torch.drawers.rudalle import BruteRuDalle
from perceptor_tpu_torch.drawers.stylegan_xl import StyleGANXL

__all__ = ["DrawingInterface", "Raw", "JPEG", "BruteDiffusion", "DeepImagePrior", "BruteRuDalle",
           "StyleGANXL"]
