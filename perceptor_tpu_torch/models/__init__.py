"""Frozen model wrappers (counterpart of perceptor_tpu/models/__init__.py).

Lazy imports keep `import perceptor_tpu_torch.models` cheap.
"""

_EXPORTS = {
    "OpenCLIP": ("perceptor_tpu_torch.models.open_clip", "OpenCLIP"),
    "CLIP": ("perceptor_tpu_torch.models.clip_alias", "CLIP"),
    "StableDiffusion": ("perceptor_tpu_torch.models.stable_diffusion", "StableDiffusion"),
    "GuidedDiffusion": ("perceptor_tpu_torch.models.guided_diffusion", "GuidedDiffusion"),
    "VelocityDiffusion": ("perceptor_tpu_torch.models.velocity_diffusion", "VelocityDiffusion"),
    "MonsterDiffusion": ("perceptor_tpu_torch.models.monster_diffusion", "MonsterDiffusion"),
    "VGG19": ("perceptor_tpu_torch.models.vgg", "VGG19"),
    "ResMem": ("perceptor_tpu_torch.models.resmem", "ResMem"),
    "SimulacraAesthetic": ("perceptor_tpu_torch.models.simulacra_aesthetic", "SimulacraAesthetic"),
    "TransformersOpenAICLIP": (
        "perceptor_tpu_torch.models.transformers_openai_clip", "TransformersOpenAICLIP"),
    "MidasDepth": ("perceptor_tpu_torch.models.midas_depth", "MidasDepth"),
    "AdaBinsDepth": ("perceptor_tpu_torch.models.adabins_depth", "AdaBinsDepth"),
    "SLIP": ("perceptor_tpu_torch.models.slip", "SLIP"),
    "BLIP": ("perceptor_tpu_torch.models.blip", "BLIP"),
    "CLOOB": ("perceptor_tpu_torch.models.cloob", "CLOOB"),
    "LiT": ("perceptor_tpu_torch.models.lit", "LiT"),
    "RuCLIP": ("perceptor_tpu_torch.models.ruclip", "RuCLIP"),
    "DeepImagePrior": ("perceptor_tpu_torch.models.deep_image_prior", "DeepImagePrior"),
    "SuperResolution": ("perceptor_tpu_torch.models.super_resolution", "SuperResolution"),
    "OWLViT": ("perceptor_tpu_torch.models.owlvit", "OWLViT"),
    "GlideCLIP": ("perceptor_tpu_torch.models.glide_clip", "GlideCLIP"),
    "StyleGANXL": ("perceptor_tpu_torch.models.stylegan_xl", "StyleGANXL"),
    # the subpackage itself (Text2Image, Face, SuperResolution, ...)
    "latent_diffusion": ("perceptor_tpu_torch.models.latent_diffusion", None),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module_name, attr = _EXPORTS[name]
        module = importlib.import_module(module_name)
        value = module if attr is None else getattr(module, attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'perceptor_tpu_torch.models' has no attribute {name!r}")
