"""Shared diffusion prediction algebra (counterpart of
perceptor_tpu/predictions/base.py), written over the canonical quantities

    from_xs          diffused state in x-space            (N, C, H, W)
    from_alphas/..   per-sample signal/noise scales       (N, 1, 1, 1)
    denoised_xs      predicted clean state                (N, C, H, W)
    predicted_noise  predicted eps                        (N, C, H, W)

with the identity  from_xs = denoised_xs * alpha + predicted_noise * sigma.
Only the deterministic methods of the guided step are ported; the
stochastic samplers and thresholds wait (ROADMAP queue A).
"""

from __future__ import annotations

import torch


def expand_like_batch(values, reference: torch.Tensor) -> torch.Tensor:
    """Broadcast scalar / (N,) schedule values to (N, 1, 1, 1)."""
    dtype = torch.promote_types(reference.dtype, torch.float32)
    values = torch.as_tensor(values, dtype=dtype, device=reference.device)
    if values.ndim == 0:
        values = values[None]
    if values.ndim != 1:
        raise ValueError("schedule values must be scalars or 1D arrays")
    return values.reshape(values.shape[0], *([1] * (reference.ndim - 1)))


class PredictionAlgebra:
    """Mixin over the subclass contract of perceptor_tpu/predictions/base.py:
    alphas(t), sigmas(t), from_alphas, from_sigmas, from_xs, denoised_xs,
    predicted_noise, _output, _replace_output, _from_pair, _decode_xs."""

    def step(self, to, eta: float = 0.0):
        """Deterministic DDIM update to noise level `to` (eta = 0)."""
        if eta != 0.0:
            raise NotImplementedError("step(eta>0) is not ported yet")
        to_alphas, to_sigmas = self.alphas(to), self.sigmas(to)
        to_xs = self.denoised_xs * to_alphas + self.predicted_noise * to_sigmas
        return self._decode_xs(to_xs)

    def guided(self, guiding, guidance_scale: float = 0.5, clamp_value: float = 1e-6):
        """Add a (clamped, normalized) loss gradient onto the network output,
        scaled by sigma."""
        shift = (
            guidance_scale
            * self.from_sigmas
            * torch.clamp(guiding, -clamp_value, clamp_value)
            / clamp_value
        )
        return self._replace_output(self._output + shift)

    def forced_denoised_xs(self, denoised_xs):
        """Replace the denoised estimate, rederiving the output field (the
        old noise is kept where sigma < 1e-3)."""
        safe_sigmas = torch.clamp(self.from_sigmas, min=1e-7)
        new_noise = (self.from_xs - denoised_xs * self.from_alphas) / safe_sigmas
        predicted_noise = torch.where(
            self.from_sigmas >= 1e-3, new_noise, self.predicted_noise
        )
        return self._from_pair(denoised_xs, predicted_noise)

    def forced_predicted_noise(self, predicted_noise):
        """Replace the noise estimate, rederiving the output field (same
        guard on alpha)."""
        safe_alphas = torch.clamp(self.from_alphas, min=1e-7)
        new_denoised = (self.from_xs - predicted_noise * self.from_sigmas) / safe_alphas
        denoised_xs = torch.where(
            self.from_alphas >= 1e-3, new_denoised, self.denoised_xs
        )
        return self._from_pair(denoised_xs, predicted_noise)
