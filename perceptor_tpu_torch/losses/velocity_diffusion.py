"""Diffusion-as-prior loss with RePaint noise resampling (counterpart of
perceptor_tpu/losses/velocity_diffusion.py).

The loss holds a noise tensor. `diffuse_denoise` diffuses images with it to
`from_ts` and returns the model's denoised images; `forward` is the MSE
against that (frozen) target; `guided_resample_` moves the held noise
against the gradient of an outside loss and resamples it (RePaint);
`compensate_noise_` shifts it by a change of the denoised images.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from perceptor_tpu_torch.losses.interface import LossInterface
from perceptor_tpu_torch.ops.clamp import clamp_with_grad
from perceptor_tpu_torch.predictions import diffusion_space


class VelocityDiffusion(LossInterface):
    def __init__(self, model, noise, from_ts: float = 0.5, resample_ts: float = 0.3):
        self.model = model
        self.from_ts = from_ts
        self.resample_ts = resample_ts
        self.noise = torch.as_tensor(noise, device=model.device)

    def _predictions(self, denoised, noise, **extra_kwargs):
        diffused = self.model.diffuse(denoised, self.from_ts, noise=noise)
        return self.model.predictions(diffused, self.from_ts, **extra_kwargs)

    def diffuse_denoise(self, denoised, noise=None, **extra_kwargs):
        noise = self.noise if noise is None else noise
        return self._predictions(denoised, noise, **extra_kwargs).denoised_images

    def forward(self, images, frozen_diffused_denoised):
        """MSE against the (detached) diffused-denoised target."""
        target = torch.clamp(frozen_diffused_denoised.detach(), 0, 1)
        return torch.square(target - clamp_with_grad(images)).mean()

    def guided_resample_(
        self,
        denoised,
        loss_fn: Callable,
        generator: Optional[torch.Generator],
        guidance_scale: float = 0.5,
        clamp_value: float = 1e-6,
        **extra_kwargs,
    ):
        """Resample the held noise in the direction of -d loss / d noise:
        `loss_fn(diffused-denoised images) -> scalar`. Returns (loss value,
        diffused-denoised images), both detached; updates `self.noise`."""
        noise = self.noise.detach().requires_grad_(True)
        with torch.enable_grad():
            predictions = self._predictions(denoised, noise, **extra_kwargs)
            images = predictions.denoised_images
            loss = loss_fn(images)
            (noise_grad,) = torch.autograd.grad(loss, noise)
        guided = predictions.detached().guided(
            -noise_grad, guidance_scale=guidance_scale, clamp_value=clamp_value
        )
        self.noise = guided.resample_noise(self.resample_ts, generator)
        return loss.detach(), images.detach()

    def compensate_noise_(self, from_denoised, to_denoised):
        delta = diffusion_space.encode(to_denoised) - diffusion_space.encode(from_denoised)
        self.noise = self.noise - delta.detach()
        return self
