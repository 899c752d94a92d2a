"""AVA aesthetic loss: CLIP ViT-B-16 and a 10-way linear head
(counterpart of perceptor_tpu/losses/aesthetic_visual_assessment.py), in
three modes: `logit` (the target class's logit), `expected` (the squared
distance of the softmax-weighted classes 1..10 to the target) and
`probability` (the target class's probability). No head is in the tree:
the untrained head is drawn as the JAX package draws it
(`np.random.default_rng(0)`, N(0, D^-1/2), bias 0).
"""

from __future__ import annotations

import numpy as np
import torch

from perceptor_tpu_torch import models
from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.simulacra_aesthetic import LinearProbe
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found


class AestheticVisualAssessment(LossInterface):
    def __init__(self, aesthetic_target: int = 10, mode: str = "expected", **kwargs):
        """`kwargs` go to `models.CLIP` (`precision`, `config`, `device`,
        `seed`)."""
        if mode not in ("logit", "expected", "probability"):
            raise ValueError(f"Unknown mode: {mode}")
        self.aesthetic_target = aesthetic_target
        self.mode = mode
        self.model = models.CLIP("ViT-B-16", **kwargs)
        dim = self.model.config.embed_dim
        rng = np.random.default_rng(0)
        head = rng.normal(0, dim**-0.5, (dim, 10)).astype(np.float32)
        self.probe = LinearProbe(torch.as_tensor(head, device=self.model.device),
                                 torch.zeros((10,), device=self.model.device))
        path = find_checkpoint("ava_vit_b_16", "ava_vit_b_16_full")
        if path is not None:
            load_found(path, {"probe": self.probe}, from_upstream=self._load_upstream)
        self._classes = torch.arange(1, 11, dtype=torch.float32, device=self.model.device)

    @property
    def weight(self) -> torch.Tensor:
        return self.probe.kernel

    @property
    def bias(self) -> torch.Tensor:
        return self.probe.bias

    def _load_upstream(self, state_dict) -> None:
        """The upstream head: `weight` (10, D) and `bias` (10,)."""
        self.probe.load_state_dict({"kernel": torch.as_tensor(state_dict["weight"]).T,
                                    "bias": torch.as_tensor(state_dict["bias"])})

    def forward(self, images) -> torch.Tensor:
        encodings = self.model.encode_images(images, normalize=False).float()
        log_probs = encodings @ self.weight + self.bias
        if self.mode == "logit":
            return -log_probs[..., self.aesthetic_target - 1].mean() * 0.01
        if self.mode == "expected":
            expected = torch.softmax(log_probs, dim=-1) * self._classes
            return torch.square(expected - self.aesthetic_target).mean() * 0.01
        return -torch.softmax(log_probs, dim=-1)[..., self.aesthetic_target - 1].mean()
