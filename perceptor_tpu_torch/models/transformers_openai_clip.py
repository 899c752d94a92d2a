"""TransformersOpenAICLIP: the HF-layout CLIP (counterpart of
perceptor_tpu/models/transformers_openai_clip.py).

The same computation as `models.OpenCLIP` with the openai configuration
(resize -> CLIP mean / std -> tower -> L2), bf16 unless `precision="fp32"`;
it loads HF `transformers` CLIPModel state_dicts (split q / k / v,
`fc1` / `fc2`) through `convert.open_clip_state_dict_from_hf`, a key map
onto the port's own towers: nothing of `transformers` is imported. The
multilingual M-CLIP text variants are not supported. For one architecture
and seed its random weights are `models.CLIP`'s, but the tower is its own:
loading HF weights here leaves `models.CLIP`'s untouched. Memoized like
`OpenCLIP`.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from perceptor_tpu_torch.convert import open_clip_state_dict_from_hf
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer
from perceptor_tpu_torch.models.open_clip import OpenCLIP
from perceptor_tpu_torch.utils.cache import cache

# HF model name -> open_clip architecture; the laion ids are the reference's
# documented list. All are built with the openai configuration (QuickGELU),
# as the JAX package builds them.
NAME_TO_ARCH = {
    "openai/clip-vit-base-patch32": "ViT-B-32-quickgelu",
    "openai/clip-vit-base-patch16": "ViT-B-16-quickgelu",
    "openai/clip-vit-large-patch14": "ViT-L-14-quickgelu",
    "openai/clip-vit-large-patch14-336": "ViT-L-14-336-quickgelu",
    "laion/CLIP-ViT-H-14-laion2B-s32B-b79K": "ViT-H-14",
    "laion/CLIP-ViT-g-14-laion2B-s12B-b42K": "ViT-g-14",
    "laion/CLIP-ViT-L-14-laion2B-s32B-b82K": "ViT-L-14",
    "laion/CLIP-ViT-B-32-laion2B-s34B-b79K": "ViT-B-32",
}


# `OpenCLIP` is memoized by `utils/cache.py`, which wraps the class in a
# function; `__wrapped__` is the class itself
@cache
class TransformersOpenAICLIP(OpenCLIP.__wrapped__):
    def __init__(
        self,
        name: str = "openai/clip-vit-large-patch14",
        tokenizer: Optional[SimpleTokenizer] = None,
        device="cuda",
        seed: int = 0,
        **kwargs,
    ):
        """`kwargs` are `precision` and `config` of `models.OpenCLIP`."""
        if name not in NAME_TO_ARCH:
            raise ValueError(
                f"unknown transformers clip model: {name} "
                f"(multilingual M-CLIP variants are not yet supported)"
            )
        self.name = name
        super().__init__(NAME_TO_ARCH[name], "openai", tokenizer=tokenizer, device=device,
                         seed=seed, **kwargs)

    def _checkpoint_names(self):
        return (f"transformers_clip_{self.name.replace('/', '_')}", self.name)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """An HF `CLIPModel` state_dict."""
        super().load_state_dict(open_clip_state_dict_from_hf(state_dict, self.config))
