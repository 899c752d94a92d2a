"""Simulacra aesthetic model: a linear probe on CLIP image embeddings
(counterpart of perceptor_tpu/models/simulacra_aesthetic.py).

rating = normalize(clip_image_embedding) * sqrt(D) @ weight + bias, over
the memoized `models.CLIP(model_name)`, so two losses on one tower share
it. No probe is in the tree: the untrained probe is drawn as the JAX
package draws it (`np.random.default_rng(0)`, N(0, D^-1/2), bias 0), so
both hold the same one. A probe file is found as JAX finds it: in the
cache directories under `simulacra_<model_name>`, then in a directory of
the reference's own layout named by `PERCEPTOR_TPU_SIMULACRA_DIR`;
`load_state_dict` takes upstream's `linear.weight` (1, D) and
`linear.bias`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping

import numpy as np
import torch

from perceptor_tpu_torch import models
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

MODEL_NAMES = (
    "ViT-B-32", "ViT-B-16", "ViT-L-14", "RN50", "RN101", "RN50x4",
    "RN50x16", "RN50x64", "ViT-L-14-336",
)


# the reference's file naming: {name}.pth, the 336px ViT with a "px" suffix
_DIST_FILENAMES = {"ViT-L-14-336": "ViT-L-14-336px"}


def distribution_path(model_name: str) -> str:
    """The probe's file in a reference-layout weights directory
    (`PERCEPTOR_TPU_SIMULACRA_DIR`), or "" without one."""
    weights_dir = os.environ.get("PERCEPTOR_TPU_SIMULACRA_DIR", "")
    if not weights_dir:
        return ""
    return os.path.join(weights_dir, _DIST_FILENAMES.get(model_name, model_name) + ".pth")


class LinearProbe(torch.nn.Module):
    """A frozen fp32 linear head on embeddings: `kernel` (D, K), `bias` (K,),
    applied as `x @ kernel + bias` (the JAX package's layout)."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("kernel", kernel)
        self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


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
        self.probe = LinearProbe(torch.as_tensor(probe, device=self.clip_model.device),
                                 torch.zeros((1,), device=self.clip_model.device))
        path = find_checkpoint(f"simulacra_{model_name}", distribution_path(model_name))
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self.load_state_dict)

    @property
    def weight(self) -> torch.Tensor:
        return self.probe.kernel

    @property
    def bias(self) -> torch.Tensor:
        return self.probe.bias

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint fills, by name."""
        return {"probe": self.probe}

    @staticmethod
    def _from_jax(params) -> Dict[str, Dict[str, torch.Tensor]]:
        linear = params["linear"]
        return {"probe": {"kernel": torch.as_tensor(linear["weight"]),
                          "bias": torch.as_tensor(linear["bias"])}}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        weight = torch.as_tensor(state_dict["linear.weight"], dtype=torch.float32).T
        if tuple(weight.shape) != (self.embed_dim, 1):
            raise ValueError(
                f"simulacra probe for {self.model_name} has weight shape "
                f"{tuple(weight.shape)}, expected ({self.embed_dim}, 1)"
            )
        self.probe.load_state_dict({"kernel": weight.contiguous(), "bias": torch.as_tensor(
            state_dict["linear.bias"], dtype=torch.float32)})

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) in [0, 1] -> (N, 1) ratings."""
        encodings = self.clip_model.encode_images(images).float()
        encodings = encodings / torch.clamp(
            torch.linalg.norm(encodings, dim=-1, keepdim=True), min=1e-12)
        return encodings * math.sqrt(encodings.shape[-1]) @ self.weight + self.bias

    forward = __call__
