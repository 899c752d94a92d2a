"""Latent-space eps predictions on a discrete DDPM schedule (counterpart of
perceptor_tpu/predictions/indexed.py `LatentIndexedEpsPredictions`).

The JAX `core/pytree.Functional` record becomes a frozen dataclass with
`dataclasses.replace`; schedule lookup is tensor indexing into the
1000-entry alpha/sigma tables carried on the object.
"""

from __future__ import annotations

import dataclasses

import torch

from perceptor_tpu_torch.predictions.base import PredictionAlgebra, expand_like_batch


@dataclasses.dataclass(frozen=True)
class LatentIndexedEpsPredictions(PredictionAlgebra):
    """Stable Diffusion eps predictions; x-space is latent space."""

    from_diffused_latents: torch.Tensor  # (N, C, H/8, W/8)
    from_indices: torch.Tensor  # (N,) int
    predicted_noise: torch.Tensor  # (N, C, H/8, W/8)
    schedule_alphas: torch.Tensor  # (T,)
    schedule_sigmas: torch.Tensor  # (T,)

    def replace(self, **changes) -> "LatentIndexedEpsPredictions":
        return dataclasses.replace(self, **changes)

    def _lookup(self, table: torch.Tensor, indices) -> torch.Tensor:
        indices = torch.as_tensor(indices, device=table.device)
        if indices.ndim == 0:
            indices = indices[None]
        if indices.ndim != 1:
            raise ValueError("indices must be a scalar or a 1D array")
        return expand_like_batch(table[indices.long()], self.predicted_noise)

    def alphas(self, indices):
        return self._lookup(self.schedule_alphas, indices)

    def sigmas(self, indices):
        return self._lookup(self.schedule_sigmas, indices)

    @property
    def from_alphas(self):
        return self.alphas(self.from_indices)

    @property
    def from_sigmas(self):
        return self.sigmas(self.from_indices)

    @property
    def from_xs(self):
        return self.from_diffused_latents

    @property
    def denoised_xs(self):
        """(from_xs - sigma * eps) / alpha, alpha clamped away from 0."""
        return (
            self.from_xs - self.from_sigmas * self.predicted_noise
        ) / torch.clamp(self.from_alphas, min=1e-7)

    @property
    def _output(self):
        return self.predicted_noise

    def _replace_output(self, predicted_noise):
        return self.replace(predicted_noise=predicted_noise)

    def _from_pair(self, denoised_xs, predicted_noise):
        del denoised_xs  # eps parameterization: the pair collapses to eps
        return self.replace(predicted_noise=predicted_noise)

    def _decode_xs(self, xs):
        return xs

    def forced_denoised_latents(self, denoised_latents):
        """SD always rederives eps with a sigma clamp (no small-sigma
        keep-old branch)."""
        predicted_noise = (
            self.from_diffused_latents - denoised_latents * self.from_alphas
        ) / torch.clamp(self.from_sigmas, min=1e-7)
        return self.replace(predicted_noise=predicted_noise)
