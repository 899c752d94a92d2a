"""Shared diffusion prediction algebra (counterpart of
perceptor_tpu/predictions/base.py), written over the canonical quantities

    from_xs          diffused state in x-space            (N, C, H, W)
    from_alphas/..   per-sample signal/noise scales       (N, 1, 1, 1)
    denoised_xs      predicted clean state                (N, C, H, W)
    predicted_noise  predicted eps                        (N, C, H, W)

with the identity  from_xs = denoised_xs * alpha + predicted_noise * sigma.
Stochastic methods draw their noise from an explicit `torch.Generator`,
never the global RNG.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceptor_tpu_torch.ops.clamp import clamp_with_grad


def expand_like_batch(values, reference: torch.Tensor) -> torch.Tensor:
    """Broadcast scalar / (N,) schedule values to (N, 1, 1, 1)."""
    dtype = torch.promote_types(reference.dtype, torch.float32)
    values = torch.as_tensor(values, dtype=dtype, device=reference.device)
    if values.ndim == 0:
        values = values[None]
    if values.ndim != 1:
        raise ValueError("schedule values must be scalars or 1D arrays")
    return values.reshape(values.shape[0], *([1] * (reference.ndim - 1)))


class NoiseStream:
    """Pre-drawn noise standing where a `torch.Generator` would: the i-th
    `randn_like` call takes `draws[i]`. An exported program cannot take a
    generator, so it takes the noise its sampler would draw as a tensor,
    drawn beforehand by `draw_noise` from the generator the eager sampler
    would use, in the same order and shapes, hence the same numbers."""

    def __init__(self, draws: torch.Tensor):
        self.draws = draws
        self.index = 0

    def next(self, reference: torch.Tensor) -> torch.Tensor:
        if self.index >= self.draws.shape[0]:
            raise ValueError(f"the noise holds {self.draws.shape[0]} draws; the sampler "
                             "asked for more")
        out = self.draws[self.index]
        if out.shape != reference.shape:
            raise ValueError(f"noise draw of shape {tuple(out.shape)}, the sampler needs "
                             f"{tuple(reference.shape)}")
        self.index += 1
        return out.to(reference.dtype)


def draw_noise(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """(n, *draw_shape) standard normal noise from `generator`, drawn one
    draw at a time as `randn_like` would draw it (so the numbers are the
    eager sampler's); an empty tensor when n is 0."""
    n, *draw_shape = shape
    if n == 0:
        return torch.zeros(shape, dtype=dtype, device=generator.device)
    return torch.stack([torch.randn(draw_shape, generator=generator, device=generator.device,
                                    dtype=dtype) for _ in range(n)])


def randn_like(reference: torch.Tensor, generator) -> torch.Tensor:
    """Standard normal noise of `reference`'s shape, dtype and device from
    `generator` (a `torch.Generator` or a `NoiseStream`), which must be
    given."""
    if generator is None:
        raise ValueError("stochastic methods need an explicit generator=")
    if isinstance(generator, NoiseStream):
        return generator.next(reference)
    return torch.randn(
        reference.shape, generator=generator, device=reference.device, dtype=reference.dtype
    )


def quantile_threshold(xs: torch.Tensor, quantile: float, minimum: float) -> torch.Tensor:
    """Per-sample `quantile` of |xs|, at least `minimum`, shaped (N, 1, 1, 1)
    and returned in the dtype that `expand_like_batch` gives. The quantile
    is jnp.quantile's linear interpolation, computed as JAX does it: in
    fp32, between the order statistics at floor and ceil of
    quantile * (n - 1) (`torch.kthvalue`), NaN for a row that holds one.
    `torch.quantile` refuses rows of more than 2**24 elements; this takes
    rows of any size."""
    flat = xs.reshape(xs.shape[0], -1).abs().float()
    n = flat.shape[1]
    position = torch.tensor(quantile, dtype=torch.float32) * (n - 1)
    low, high = position.floor(), position.ceil()
    high_weight = position - low

    def order_statistic(rank):
        return flat.kthvalue(int(rank.clamp(0, n - 1)) + 1, dim=1).values

    low_value = order_statistic(low)
    high_value = low_value if high == low else order_statistic(high)
    values = low_value * (1 - high_weight) + high_value * high_weight
    values = torch.where(flat.isnan().any(dim=1), torch.nan, values)
    return expand_like_batch(torch.clamp(values, min=minimum), xs)


class PredictionAlgebra:
    """Mixin over the subclass contract of perceptor_tpu/predictions/base.py:
    alphas(t), sigmas(t), from_alphas, from_sigmas, from_xs, denoised_xs,
    predicted_noise, _output, _replace_output, _from_pair, _decode_xs, and
    `_FROM_FIELD`, the name of the dataclass field that holds the diffused
    input."""

    _FROM_FIELD = ""

    def detached(self, from_input=None):
        """A copy cut from the autograd graph: the network output detached
        and the diffused input replaced by `from_input` (default: its own,
        detached)."""
        if from_input is None:
            from_input = getattr(self, self._FROM_FIELD).detach()
        return self._replace_output(self._output.detach()).replace(
            **{self._FROM_FIELD: from_input}
        )

    @property
    def denoised_images(self):
        return self._decode_xs(self.denoised_xs)

    # -- samplers ----------------------------------------------------------

    def step(self, to, eta: float = 0.0, generator: Optional[torch.Generator] = None):
        """DDIM update to noise level `to`; eta > 0 adds fresh noise from
        `generator`. A tensor `eta` (an exported program's argument) always
        takes the stochastic branch."""
        to_alphas, to_sigmas = self.alphas(to), self.sigmas(to)
        if isinstance(eta, torch.Tensor) or eta > 0.0:
            ddim_sigma = (
                eta
                * torch.sqrt(to_sigmas**2 / self.from_sigmas**2)
                * torch.sqrt(1 - self.from_alphas**2 / to_alphas**2)
            )
            adjusted_sigma = torch.sqrt(to_sigmas**2 - ddim_sigma**2)
            to_xs = self.denoised_xs * to_alphas + self.predicted_noise * adjusted_sigma
            to_xs = to_xs + randn_like(to_xs, generator) * ddim_sigma
        else:
            to_xs = self.denoised_xs * to_alphas + self.predicted_noise * to_sigmas
        return self._decode_xs(to_xs)

    def correction(self, previous):
        """PNDM-ish second-order correction: average two denoised estimates."""
        return previous.forced_denoised_xs((self.denoised_xs + previous.denoised_xs) / 2)

    def reverse_step(self, to):
        """Deterministic DDIM inversion toward higher noise."""
        to_alphas, to_sigmas = self.alphas(to), self.sigmas(to)
        return self._decode_xs(self.denoised_xs * to_alphas + self.predicted_noise * to_sigmas)

    def dpm_solver_pp_step(self, to, prev_denoised_xs, prev_h, is_first):
        """DPM-Solver++(2M) multistep update (predictions/dpm_solver.py).
        Carry `denoised_xs` and the returned `h` into the next step;
        `is_first` selects the first-order update. Returns
        (next_state_decoded, h)."""
        from perceptor_tpu_torch.predictions.dpm_solver import dpm_pp_2m_update

        to_xs, h = dpm_pp_2m_update(
            self.from_xs,
            self.denoised_xs,
            prev_denoised_xs,
            prev_h,
            self.from_alphas,
            self.from_sigmas,
            self.alphas(to),
            self.sigmas(to),
            is_first,
        )
        return self._decode_xs(to_xs), h

    def resample_noise(self, resample, generator: Optional[torch.Generator] = None):
        """RePaint harmonizing noise at level `resample`."""
        resample_sigmas = self.sigmas(resample)
        fresh = randn_like(self.predicted_noise, generator)
        resampled = (
            resample_sigmas * self.predicted_noise
            + torch.sqrt(self.from_sigmas**2 - resample_sigmas**2) * fresh
        )
        return resampled / self.from_sigmas

    def resample(self, resample, generator: Optional[torch.Generator] = None):
        """RePaint resampling step (https://github.com/andreas128/RePaint)."""
        return self._decode_xs(
            self.denoised_xs * self.from_alphas
            + self.resample_noise(resample, generator) * self.from_sigmas
        )

    def noisy_reverse_step(self, to, generator: Optional[torch.Generator] = None):
        """Stochastic renoising toward higher noise level `to`."""
        to_alphas, to_sigmas = self.alphas(to), self.sigmas(to)
        fresh = randn_like(self.predicted_noise, generator)
        noise_sigma = (
            self.from_sigmas * self.predicted_noise
            + torch.sqrt(to_sigmas**2 - self.from_sigmas**2) * fresh
        )
        return self._decode_xs(self.denoised_xs * to_alphas + noise_sigma)

    # -- guidance ----------------------------------------------------------

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

    def classifier_free_guidance(self, positive, guidance_scale: float = 7.0):
        """uncond + (positive - uncond) * scale on the raw output field."""
        return self._replace_output(
            self._output + (positive._output - self._output) * guidance_scale
        )

    # -- thresholding ------------------------------------------------------

    def dynamic_threshold(self, quantile: float = 0.95):
        """Imagen-style percentile clamp on denoised x."""
        if quantile is None:
            return self
        threshold = quantile_threshold(self.denoised_xs, quantile, 1.0)
        denoised_xs = clamp_with_grad(self.denoised_xs, -threshold, threshold)
        return self.forced_denoised_xs(denoised_xs / threshold)

    def static_threshold(self):
        """Clamp denoised x to [-1, 1]."""
        return self.forced_denoised_xs(clamp_with_grad(self.denoised_xs, -1.0, 1.0))

    # -- forcing -----------------------------------------------------------

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

    # -- diagnostics ---------------------------------------------------------

    def _wasserstein_residuals(self):
        noise = self.predicted_noise
        sorted_noise = torch.sort(noise.reshape(noise.shape[0], -1), dim=1).values
        n = sorted_noise.shape[1]
        margin = 0.5 / n
        points = torch.linspace(margin, 1 - margin, n, device=noise.device)
        expected = torch.special.ndtri(points).to(sorted_noise.dtype)
        return sorted_noise - expected[None]

    def wasserstein_distance(self):
        """Gaussianity diagnostic on the predicted noise: mean absolute
        distance of its sorted values from the normal quantiles."""
        return self._wasserstein_residuals().abs().mean()

    def wasserstein_square_distance(self):
        return torch.square(self._wasserstein_residuals()).mean()
