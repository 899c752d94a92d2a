"""Guidance objectives (counterpart of perceptor_tpu/losses/__init__.py).

A loss of the JAX package that is not ported yet raises an AttributeError
that says so; ROADMAP.md queue A lists the order in which they come.
"""

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.losses.prompt_bank import PromptBankLoss
from perceptor_tpu_torch.losses.resize import Resize
from perceptor_tpu_torch.losses.smoothness import Smoothness
from perceptor_tpu_torch.losses.spherical_distance import SphericalDistance

_LAZY = {
    "CLIP": ("perceptor_tpu_torch.losses.clip", "CLIP"),
    "OpenCLIP": ("perceptor_tpu_torch.losses.open_clip", "OpenCLIP"),
    "VelocityDiffusion": ("perceptor_tpu_torch.losses.velocity_diffusion", "VelocityDiffusion"),
    "LPIPS": ("perceptor_tpu_torch.losses.lpips", "LPIPS"),
    "StyleTransfer": ("perceptor_tpu_torch.losses.style_transfer", "StyleTransfer"),
    "Memorability": ("perceptor_tpu_torch.losses.memorability", "Memorability"),
    "SimulacraAesthetic": ("perceptor_tpu_torch.losses.simulacra_aesthetic", "SimulacraAesthetic"),
    "AestheticVisualAssessment": (
        "perceptor_tpu_torch.losses.aesthetic_visual_assessment", "AestheticVisualAssessment"),
    "TransformersOpenAICLIP": (
        "perceptor_tpu_torch.losses.transformers_openai_clip", "TransformersOpenAICLIP"),
    "MidasDepth": ("perceptor_tpu_torch.losses.midas_depth", "MidasDepth"),
}

_NOT_PORTED = (
    "BLIP", "CLOOB", "SLIP", "RuCLIP", "LiT", "OWLViT", "SuperResolution",
    "SuperResolutionDiscriminator",
)

__all__ = ["LossInterface", "PromptBankLoss", "Smoothness", "Resize", "SphericalDistance"] + list(
    _LAZY
)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        value = getattr(importlib.import_module(module_name), attr)
        globals()[name] = value
        return value
    if name in _NOT_PORTED:
        raise AttributeError(
            f"perceptor_tpu_torch.losses.{name} is not ported yet (ROADMAP.md queue A)"
        )
    raise AttributeError(f"module 'perceptor_tpu_torch.losses' has no attribute {name!r}")
