"""The LDM family's schedule, DDIM update and sampling loop (counterpart of
perceptor_tpu/models/latent_diffusion/ddim.py and of the index-space
methods the JAX Text2Image, Face and SuperResolution each carry).

`LatentDiffusionSchedule` holds what the three wrappers share: the
scaled-linear alpha/sigma tables on the device, `alphas_cumprod`, `diffuse`,
the DDIM `step` with eta and the linear `schedule_indices`. `sample_loop`
is the eager counterpart of JAX's `build_ldm_sample_run` program: per
(from, to) pair eps -> denoise -> DDIM update (or DPM-Solver++(2M)), then
the final denoise and the first-stage decode. Noise comes from an explicit
`torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from perceptor_tpu_torch.predictions import base
from perceptor_tpu_torch.predictions.dpm_solver import dpm_pp_2m_update
from perceptor_tpu_torch.schedules import scaled_linear_alphas_sigmas

METHODS = ("ddim", "dpm++")


def ddim_update(latents, eps, denoised, from_ac, to_ac, eta, noise):
    """One DDIM update in alphas-cumprod index space; `from_ac` / `to_ac`
    broadcast against the latents, and eta 0 is the deterministic update
    (`to_sigmas` is then 0)."""
    to_sigmas = eta * torch.sqrt((1 - to_ac) / (1 - from_ac) * (1 - from_ac / to_ac))
    dir_xt = torch.sqrt(1.0 - to_ac - to_sigmas**2) * eps
    return torch.sqrt(to_ac) * denoised + dir_xt + to_sigmas * noise


def check_method(method: str, eta, hint: str = "") -> None:
    if method not in METHODS:
        raise ValueError(f"unknown sampling method: {method!r}")
    if method == "dpm++" and float(eta) > 0.0:
        raise ValueError(f"dpm++ is deterministic: eta does not apply{hint}")


class LatentDiffusionSchedule:
    """The index-space schedule methods of the three LDM wrappers. A
    subclass sets `device` and `eta`, then calls `_set_schedule`."""

    def _set_schedule(self, beta_start: float, beta_end: float) -> None:
        alphas, sigmas = scaled_linear_alphas_sigmas(1000, beta_start, beta_end)
        self.schedule_alphas = torch.as_tensor(alphas, device=self.device)
        self.schedule_sigmas = torch.as_tensor(sigmas, device=self.device)

    def schedule_indices(self, from_index=999, to_index=50, n_steps=None,
                         unique: bool = True) -> np.ndarray:
        """(k, 2) (from, to) pairs of a linear index ramp."""
        if from_index < to_index:
            raise ValueError("from_index must be greater than to_index")
        if n_steps is None:
            n_steps = (from_index - to_index) // 2
        indices = np.linspace(from_index, to_index, n_steps).astype(np.int64)
        if unique and (indices[:-1] == indices[1:]).any():
            raise ValueError("Schedule indices must be unique")
        return np.stack([indices[:-1], indices[1:]], axis=1)

    def alphas_cumprod(self, index) -> torch.Tensor:
        return torch.square(self.schedule_alphas[int(index)])[None, None, None, None]

    def sqrt_one_minus_alphas_cumprod(self, index) -> torch.Tensor:
        return self.schedule_sigmas[int(index)][None, None, None, None]

    def diffuse(self, latents, index, noise=None, generator: Optional[torch.Generator] = None):
        """q-sample at schedule `index`."""
        if noise is None:
            if generator is None:
                raise ValueError("diffuse is stochastic: pass noise= or generator=")
            noise = base.randn_like(latents, generator)
        return (
            latents * torch.sqrt(self.alphas_cumprod(index))
            + noise * self.sqrt_one_minus_alphas_cumprod(index)
        )

    def _denoised(self, latents, index, eps):
        return (
            latents - self.sqrt_one_minus_alphas_cumprod(index) * eps
        ) / torch.sqrt(self.alphas_cumprod(index))

    def step(self, from_latents, predicted_denoised_latents, from_index, to_index,
             noise=None, generator: Optional[torch.Generator] = None):
        """DDIM update with the model's `eta`; noise from `noise`, else from
        `generator`, else none (only for eta 0)."""
        if to_index > from_index:
            raise ValueError("to_index must be smaller than from_index")
        if noise is None:
            if generator is not None:
                noise = base.randn_like(predicted_denoised_latents, generator)
            elif self.eta > 0:
                raise ValueError("step with eta>0 is stochastic: pass generator=")
            else:
                noise = torch.zeros_like(predicted_denoised_latents)
        from_ac = self.alphas_cumprod(from_index)
        to_ac = self.alphas_cumprod(to_index)
        eps = (
            from_latents - predicted_denoised_latents * torch.sqrt(from_ac)
        ) / self.sqrt_one_minus_alphas_cumprod(from_index)
        return ddim_update(from_latents, eps, predicted_denoised_latents, from_ac, to_ac,
                           self.eta, noise)

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    def _sample_loop(self, latents, pairs, eps_fn: Callable, decode: Callable, eta: float,
                     generator: Optional[torch.Generator], method: str):
        """Per pair eps_fn(latents, from_index) -> denoise -> DDIM update
        (noise from `generator` when eta > 0) or DPM-Solver++(2M) over
        alpha = sqrt(ac), sigma = sqrt(1 - ac); then the final denoise and
        `decode`. k pairs are k + 1 model evaluations."""
        pairs = np.asarray(pairs)
        prev_x0 = torch.zeros_like(latents)
        prev_h = torch.ones((1, 1, 1, 1), device=latents.device)
        for i, (from_i, to_i) in enumerate(pairs):
            eps = eps_fn(latents, int(from_i))
            denoised = self._denoised(latents, from_i, eps)
            from_ac, to_ac = self.alphas_cumprod(from_i), self.alphas_cumprod(to_i)
            if method == "dpm++":
                latents, prev_h = dpm_pp_2m_update(
                    latents, denoised, prev_x0, prev_h,
                    torch.sqrt(from_ac), torch.sqrt(1.0 - from_ac),
                    torch.sqrt(to_ac), torch.sqrt(1.0 - to_ac),
                    i == 0,
                )
                prev_x0 = denoised
            else:
                noise = (base.randn_like(latents, generator) if float(eta) > 0.0
                         else torch.zeros_like(latents))
                latents = ddim_update(latents, eps, denoised, from_ac, to_ac, eta, noise)
        final = int(pairs[-1, 1])
        return decode(self._denoised(latents, final, eps_fn(latents, final)))
