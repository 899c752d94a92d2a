"""EDM (Karras et al. 2022) denoised-parameterized predictions in sigma
space (counterpart of perceptor_tpu/predictions/edm.py).

The preconditioned network predicts the denoised x; the schedule is
alpha = 1, sigma = t (variance exploding), so

    predicted_noise (eps) = (diffused_xs - denoised_xs) / sigma
    step:  to_xs = denoised_xs + eps * to_sigma

and `heun_correction` is EDM's trapezoidal second-order update in sigma.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from perceptor_tpu_torch.predictions import base, diffusion_space
from perceptor_tpu_torch.predictions.base import PredictionAlgebra, expand_like_batch


@dataclasses.dataclass(frozen=True)
class EDMPredictions(PredictionAlgebra):
    """Denoised xs, the diffused images in [0, 1], sigmas as ts."""

    denoised_xs: torch.Tensor  # (N, C, H, W) in x-space
    diffused_images: torch.Tensor  # (N, C, H, W) in [0, 1]
    ts: torch.Tensor  # (N,) sigmas

    _FROM_FIELD = "diffused_images"

    def replace(self, **changes) -> "EDMPredictions":
        return dataclasses.replace(self, **changes)

    # -- schedule: alpha = 1, sigma = t ---------------------------------------

    def alphas(self, ts):
        return torch.ones_like(self.sigmas(ts))

    def sigmas(self, ts):
        return expand_like_batch(ts, self.denoised_xs)

    @property
    def from_alphas(self):
        return self.alphas(self.ts)

    @property
    def from_sigmas(self):
        return self.sigmas(self.ts)

    # -- canonical quantities ---------------------------------------------------

    @property
    def from_xs(self):
        return diffusion_space.encode(self.diffused_images)

    @property
    def diffused_xs(self):
        return self.from_xs

    @property
    def predicted_noise(self):
        return (self.from_xs - self.denoised_xs) / self.from_sigmas

    @property
    def eps(self):
        return self.predicted_noise

    # -- parameterization adapters ------------------------------------------------

    @property
    def _output(self):
        return self.denoised_xs

    def _replace_output(self, denoised_xs):
        return self.replace(denoised_xs=denoised_xs)

    def _from_pair(self, denoised_xs, predicted_noise):
        return self.replace(denoised_xs=denoised_xs)

    def _decode_xs(self, xs):
        return diffusion_space.decode(xs)

    # -- EDM samplers -----------------------------------------------------------

    def heun_correction(self, previous_diffused_images, previous_ts, previous_eps):
        """Heun's update from the previous point with the mean of the two
        eps slopes."""
        previous_xs = diffusion_space.encode(previous_diffused_images)
        corrected = previous_xs + (self.from_sigmas - self.sigmas(previous_ts)) * (
            self.eps + previous_eps
        ) / 2
        return diffusion_space.decode(corrected)

    def inject_noise(self, to_ts, generator: Optional[torch.Generator] = None):
        """Renoise from sigma up to the higher sigma `to_ts` with noise from
        `generator`."""
        to_sigmas = self.sigmas(to_ts)
        fresh = base.randn_like(self.from_xs, generator)
        added = torch.sqrt(torch.clamp(to_sigmas**2 - self.from_sigmas**2, min=0.0))
        return diffusion_space.decode(self.from_xs + fresh * added)
