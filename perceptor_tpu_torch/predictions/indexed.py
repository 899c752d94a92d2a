"""Latent-space eps predictions on a discrete DDPM schedule (counterpart of
perceptor_tpu/predictions/indexed.py `LatentIndexedEpsPredictions`).

The JAX `core/pytree.Functional` record becomes a frozen dataclass with
`dataclasses.replace`; schedule lookup is tensor indexing into the
1000-entry alpha/sigma tables carried on the object. `encode` and `decode`
are the frozen VAE's pixel <-> latent callables, for the pixel-space
methods (`denoised_images`, the VAE round-trip `dynamic_threshold`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.predictions import diffusion_space
from perceptor_tpu_torch.predictions.base import (
    PredictionAlgebra,
    expand_like_batch,
    quantile_threshold,
)


@dataclasses.dataclass(frozen=True)
class LatentIndexedEpsPredictions(PredictionAlgebra):
    """Stable Diffusion eps predictions; x-space is latent space."""

    from_diffused_latents: torch.Tensor  # (N, C, H/8, W/8)
    from_indices: torch.Tensor  # (N,) int
    predicted_noise: torch.Tensor  # (N, C, H/8, W/8)
    schedule_alphas: torch.Tensor  # (T,)
    schedule_sigmas: torch.Tensor  # (T,)
    encode: Optional[Callable] = dataclasses.field(default=None, compare=False)
    decode: Optional[Callable] = dataclasses.field(default=None, compare=False)

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
    def denoised_latents(self):
        return self.denoised_xs

    @property
    def denoised_images(self):
        """VAE decode of the denoised latents."""
        return self.decode(self.denoised_xs)

    @property
    def _output(self):
        return self.predicted_noise

    def _replace_output(self, predicted_noise):
        return self.replace(predicted_noise=predicted_noise)

    def _from_pair(self, denoised_xs, predicted_noise):
        del denoised_xs  # eps parameterization: the pair collapses to eps
        return self.replace(predicted_noise=predicted_noise)

    def _decode_xs(self, xs):
        # x-space is latent space: the samplers hand back latents
        return xs

    def forced_denoised_latents(self, denoised_latents):
        """SD always rederives eps with a sigma clamp (no small-sigma
        keep-old branch)."""
        predicted_noise = (
            self.from_diffused_latents - denoised_latents * self.from_alphas
        ) / torch.clamp(self.from_sigmas, min=1e-7)
        return self.replace(predicted_noise=predicted_noise)

    def latent_dynamic_threshold(self, quantile: float = 0.95):
        """Percentile clamp directly on the predicted noise (at least 2.5)."""
        if quantile is None:
            return self
        threshold = quantile_threshold(self.predicted_noise, quantile, 2.5)
        return self.forced_predicted_noise(
            clamp_with_grad(self.predicted_noise, -threshold, threshold)
        )

    def dynamic_threshold(self, quantile: float = 0.95):
        """Pixel-space Imagen threshold: decode, clamp to the per-sample
        quantile of |x| (at least 1) and rescale, encode back."""
        if quantile is None:
            return self
        denoised_xs = diffusion_space.encode(self.decode(self.denoised_latents))
        threshold = quantile_threshold(denoised_xs, quantile, 1.0)
        denoised_xs = clamp_with_grad(denoised_xs, -threshold, threshold) / threshold
        return self.forced_denoised_latents(
            self.encode(diffusion_space.decode(denoised_xs))
        )
