"""v-parameterized continuous-time predictions on the cosine schedule
(counterpart of perceptor_tpu/predictions/velocity.py).

The network predicts velocity v; with alpha = cos(t pi/2), sigma = sin(t pi/2):

    denoised_xs     = from_xs * alpha - v * sigma
    predicted_noise = from_xs * sigma + v * alpha
    v               = alpha * predicted_noise - sigma * denoised_xs
"""

from __future__ import annotations

import dataclasses

import torch

from perceptor_tpu_torch.predictions import diffusion_space
from perceptor_tpu_torch.predictions.base import PredictionAlgebra, expand_like_batch
from perceptor_tpu_torch.schedules.cosine import t_to_alpha_sigma


@dataclasses.dataclass(frozen=True)
class VelocityPredictions(PredictionAlgebra):
    """Diffused images in [0, 1], continuous ts, velocities."""

    from_diffused_images: torch.Tensor  # (N, C, H, W) in [0, 1]
    from_ts: torch.Tensor  # (N,)
    velocities: torch.Tensor  # (N, C, H, W)

    _FROM_FIELD = "from_diffused_images"

    def replace(self, **changes) -> "VelocityPredictions":
        return dataclasses.replace(self, **changes)

    def _ts(self, ts) -> torch.Tensor:
        return torch.as_tensor(ts, dtype=torch.float32, device=self.velocities.device)

    def alphas(self, ts):
        return expand_like_batch(t_to_alpha_sigma(self._ts(ts))[0], self.velocities)

    def sigmas(self, ts):
        return expand_like_batch(t_to_alpha_sigma(self._ts(ts))[1], self.velocities)

    @property
    def from_alphas(self):
        return self.alphas(self.from_ts)

    @property
    def from_sigmas(self):
        return self.sigmas(self.from_ts)

    @property
    def from_xs(self):
        return diffusion_space.encode(self.from_diffused_images)

    @property
    def denoised_xs(self):
        return self.from_xs * self.from_alphas - self.velocities * self.from_sigmas

    @property
    def predicted_noise(self):
        return self.from_xs * self.from_sigmas + self.velocities * self.from_alphas

    @property
    def _output(self):
        return self.velocities

    def _replace_output(self, velocities):
        return self.replace(velocities=velocities)

    def _from_pair(self, denoised_xs, predicted_noise):
        """v = alpha * eps - sigma * x0."""
        return self.replace(
            velocities=self.from_alphas * predicted_noise - self.from_sigmas * denoised_xs
        )

    def _decode_xs(self, xs):
        return diffusion_space.decode(xs)

    def reverse_step(self, to):
        """As the JAX class (and the code it was modelled on), this returns
        x-space, without the `diffusion_space.decode` that `step` applies."""
        to_alphas, to_sigmas = self.alphas(to), self.sigmas(to)
        return self.denoised_xs * to_alphas + self.predicted_noise * to_sigmas

    def forced_denoised_images(self, denoised_images):
        return self.forced_denoised_xs(diffusion_space.encode(denoised_images))
