"""Simulacra aesthetic model: a linear probe on CLIP image embeddings
(counterpart of perceptor_tpu/models/simulacra_aesthetic.py).

rating = normalize(clip_image_embedding) * sqrt(D) @ weight + bias, over
the memoized `models.CLIP(model_name)`, so two losses on one tower share
it. No probe is in the tree: the untrained probe is drawn as the JAX
package draws it (`np.random.default_rng(0)`, N(0, D^-1/2), bias 0), so
both hold the same one; `load_state_dict` takes upstream's `linear.weight`
(1, D) and `linear.bias`.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from perceptor_tpu_torch import models
from perceptor_tpu_torch.utils.cache import cache

MODEL_NAMES = (
    "ViT-B-32", "ViT-B-16", "ViT-L-14", "RN50", "RN101", "RN50x4",
    "RN50x16", "RN50x64", "ViT-L-14-336",
)


@cache
class SimulacraAesthetic:
    def __init__(self, model_name: str = "ViT-B-32", **kwargs):
        """`kwargs` go to `models.CLIP` (`precision`, `config`, `device`,
        `seed`)."""
        self.model_name = model_name
        self.clip_model = models.CLIP(model_name, **kwargs)
        self.embed_dim = self.clip_model.config.embed_dim
        rng = np.random.default_rng(0)
        probe = rng.normal(0, self.embed_dim**-0.5, (self.embed_dim, 1)).astype(np.float32)
        self.weight = torch.as_tensor(probe, device=self.clip_model.device)
        self.bias = torch.zeros((1,), device=self.clip_model.device)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        weight = torch.as_tensor(state_dict["linear.weight"], dtype=torch.float32).T
        if tuple(weight.shape) != (self.embed_dim, 1):
            raise ValueError(
                f"simulacra probe for {self.model_name} has weight shape "
                f"{tuple(weight.shape)}, expected ({self.embed_dim}, 1)"
            )
        self.weight = weight.contiguous().to(self.clip_model.device)
        self.bias = torch.as_tensor(state_dict["linear.bias"], dtype=torch.float32).to(
            self.clip_model.device)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) in [0, 1] -> (N, 1) ratings."""
        encodings = self.clip_model.encode_images(images).float()
        encodings = encodings / torch.clamp(
            torch.linalg.norm(encodings, dim=-1, keepdim=True), min=1e-12)
        return encodings * math.sqrt(encodings.shape[-1]) @ self.weight + self.bias

    forward = __call__
