"""OWL-ViT detection loss (counterpart of perceptor_tpu/losses/owlvit.py):
per label, the mean of the top-k patch log-probabilities (a log-softmax
over the patches), weighted, summed and scaled by -0.01."""

from __future__ import annotations

from typing import List

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.models.owlvit import OWLViT as OWLViTModel
from perceptor_tpu_torch.models.owlvit import OWLViTEncodings


class OWLViT(LossInterface):
    def __init__(self, **kwargs):
        """`kwargs` go to `models.OWLViT` (`name`, `tokenizer`,
        `precision`, `device`, `seed`)."""
        self.model = OWLViTModel(**kwargs)
        self.encodings = None
        self.weights = None

    def add_texts_(self, texts: List[str], weights=None):
        return self.add_encodings_(self.model.encode_texts([texts]), weights)

    def add_images_(self, images, weights=None):
        raise NotImplementedError()

    def add_encodings_(self, encodings: OWLViTEncodings, weights=None):
        """The one set of query encodings; a second raises."""
        if self.encodings is not None:
            raise ValueError("OWLViT can only have one set of encodings")
        n_labels = encodings.tokens.shape[0]
        if weights is None:
            weights = torch.ones((n_labels,), device=self.model.device)
        else:
            weights = torch.as_tensor(weights, dtype=torch.float32, device=self.model.device)
        self.encodings = encodings
        self.weights = weights
        return self

    def forward(self, images, top_k: int = 5):
        if self.encodings is None:
            raise ValueError("call add_texts_ first")
        predictions = self.model(images, self.encodings)
        log_probs = torch.log_softmax(
            predictions.logits.reshape(images.shape[0], -1, self.weights.shape[0]), dim=1)
        top = torch.sort(log_probs, dim=1).values[:, -top_k:]  # (N, k, labels)
        per_label = top.mean(dim=(0, 1))
        return -(per_label * self.weights).sum() * 0.01
