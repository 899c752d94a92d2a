"""The prompt-bank loss (counterpart of perceptor_tpu/losses/prompt_bank.py).

The methods `add_texts_`, `add_images_` and `add_encodings_` concatenate
L2-normalized target encodings and their weights into a bank on the model's
device; `forward(images)` is the weighted mean of squared spherical
distances between the image encodings and the bank, differentiable in
`images`. The `add_*_` methods run without gradients: encoders are frozen.

The JAX package's `(apply, loss_params)` pair, which keeps tower weights
out of a compiled program's constants, has no counterpart: an eager loss
reads its tower where it lies.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from perceptor_tpu_torch.losses.interface import LossInterface


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True), min=eps)


def spherical_distance_squared(encodings_a, encodings_b) -> torch.Tensor:
    """Pairwise (arcsin(|a-b|/2))^2 * 2, shape (len(a), len(b))."""
    diff_norm = torch.linalg.norm(encodings_a[:, None] - encodings_b[None, :], dim=2)
    return torch.square(torch.arcsin(torch.clamp(diff_norm / 2, 0.0, 1.0))) * 2


class PromptBankLoss(LossInterface):
    """Base for encoder losses with text/image prompt banks.

    `model` provides `encode_texts` and `encode_images`; the bank lives on
    `model.device` where the model has one, else on the device of the first
    encodings added.
    """

    def __init__(self, model, multiplier: float = 1.0):
        self.model = model
        self.encodings: Optional[torch.Tensor] = None
        self.bank_weights: Optional[torch.Tensor] = None
        self.multiplier = multiplier

    def mul_(self, multiplier: float):
        self.multiplier *= multiplier
        return self

    def add_texts_(self, texts: Sequence[str], weights=None):
        return self.add_encodings_(self.model.encode_texts(texts), weights)

    def add_images_(self, images, weights=None):
        with torch.no_grad():
            return self.add_encodings_(self.model.encode_images(images), weights)

    @torch.no_grad()
    def add_encodings_(self, encodings, weights=None):
        """`encodings` (n, embed) or (embed,); `weights` None (ones), a
        scalar (broadcast) or a list of n."""
        device = getattr(self.model, "device", None)
        if device is None and self.encodings is not None:
            device = self.encodings.device
        encodings = torch.as_tensor(encodings, dtype=torch.float32, device=device)
        if encodings.ndim == 1:
            encodings = encodings[None]
        n = encodings.shape[0]
        if weights is None:
            weights = torch.ones((n,), dtype=torch.float32, device=encodings.device)
        else:
            weights = torch.as_tensor(weights, dtype=torch.float32, device=encodings.device)
            if weights.ndim == 0:
                weights = weights.expand(n).clone()
        # in fp64, so an encoding that is already unit-norm in fp32 stays
        # bitwise as it was (an fp32 norm of 1 - 6e-8 would move it an ulp)
        normalized = _l2_normalize(encodings.double()).float()
        if self.encodings is None:
            self.encodings, self.bank_weights = normalized, weights
        else:
            self.encodings = torch.cat([self.encodings, normalized])
            self.bank_weights = torch.cat([self.bank_weights, weights])
        return self

    def image_encodings(self, images) -> torch.Tensor:
        return self.model.encode_images(images)

    def forward(self, images) -> torch.Tensor:
        if self.encodings is None:
            raise ValueError(
                "empty prompt bank: call add_texts_/add_images_/add_encodings_ first"
            )
        distances = spherical_distance_squared(self.image_encodings(images), self.encodings)
        return torch.mean(distances * self.bank_weights) * self.multiplier
