"""CLIP = OpenCLIP with the OpenAI configuration (counterpart of
perceptor_tpu/models/clip_alias.py).

OpenAI checkpoints use QuickGELU; names that lack the -quickgelu suffix are
fixed up the same way.
"""

from __future__ import annotations

from perceptor_tpu_torch.models.open_clip import OpenCLIP

_QUICKGELU_FIXUP = {
    "RN50": "RN50-quickgelu",
    "RN101": "RN101-quickgelu",
    "ViT-B-32": "ViT-B-32-quickgelu",
    "ViT-B-16": "ViT-B-16-quickgelu",
    "ViT-L-14": "ViT-L-14-quickgelu",
    "ViT-L-14-336": "ViT-L-14-336-quickgelu",
}


def CLIP(name: str = "ViT-B-32", precision=None, jit=None, **kwargs):
    """
    Args:
        name: CLIP model name (RN50, RN50x4, ..., ViT-B-32, ViT-B-16, ViT-L-14, ...)
        jit: accepted for callers of the JAX package's signature and
            dropped: the towers run eagerly
        kwargs: `config`, `tokenizer`, `device`, `seed` of `OpenCLIP`
    """
    del jit
    architecture = _QUICKGELU_FIXUP.get(name, name)
    return OpenCLIP(architecture, "openai", precision=precision, **kwargs)
