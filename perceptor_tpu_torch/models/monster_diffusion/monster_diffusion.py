"""MonsterDiffusion wrapper: EDM sampling of 48x48 sprites, "all" /
"tiny-hero" (counterpart of
perceptor_tpu/models/monster_diffusion/monster_diffusion.py).

  - EDM preconditioning (c_skip, c_out, c_in, c_noise) around the net, and
    `predictions()` -> EDMPredictions;
  - the rho-ramp sigma schedule (`schedule_ts`), `training_ts`, `diffuse`,
    `random_noise`;
  - the stochastic churn (`gamma`, `reversed_ts`, `inject_noise`);
  - `sample()` / `elucidated_sample()`: Heun with churn and a final churned
    denoise; `dpm_solver_sample()`: DPM-Solver++(2M);
    `linear_multistep_sample()` with host-side scipy coefficients.

Images are in [0, 1] at this boundary (x-space is [-1, 1]). Where JAX
compiles each sampler into one `lax.scan` program, here they are eager
Python loops; randomness comes from an explicit `torch.Generator`. Every
network evaluation is one batched call of the net, which launches no
flash kernel (its attention sites hold 576 and 144 tokens).

Weights are seeded random at the published widths (the tree holds no
checkpoints), stored in bf16 for matmuls and convolutions when `fp16`;
`load_state_dict` takes converted weights
(`convert.monster_state_dict_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.monster_diffusion import net as monster_net
from perceptor_tpu_torch.predictions import EDMPredictions, base, diffusion_space
from perceptor_tpu_torch.schedules import EDM, edm_preconditioning, edm_schedule_ts, edm_sigmas
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

INPUT_SHAPE = (3, 48, 48)
N_AUGMENTATIONS = 9


class MonsterDiffusion:
    def __init__(self, name: str = "all", fp16: bool = True, device="cuda", seed: int = 0):
        """`name` is "all", "tiny-hero" (the published config) or "tiny";
        `fp16` stores matmul/conv weights in bf16 (bf16 compute); weights
        are those of the checkpoint `find_checkpoint("monster_diffusion_<name>", name)`
        finds (`utils.checkpoints.load_found`), else random from `seed`; `device` is CUDA unless the caller passes
        "cpu"."""
        if name not in monster_net.MODEL_CONFIGS:
            raise ValueError(f"Unknown model name {name}")
        self.name = name
        self.config = monster_net.MODEL_CONFIGS[name]
        self.constants = EDM()
        self.device = resolve_device(device)
        self.dtype = COMPUTE_DTYPE if fp16 else torch.float32
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(monster_net.MonsterUNet, self.config, self.device, gen,
                                    self.dtype)
        path = find_checkpoint(f"monster_diffusion_{name}", name)
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self.load_state_dict)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import monster_state_dict_from_jax

        return {"module": monster_state_dict_from_jax(params, self.config)}

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint fills, by name."""
        return {"module": self.module}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load a state_dict of `MonsterUNet`; the module keeps its storage
        dtypes (bf16 matmul weights when `fp16`)."""
        self.module.load_state_dict(state_dict)
        if self.dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.module)

    @property
    def shape(self):
        return INPUT_SHAPE if self.name != "tiny" else (3, 16, 16)

    # -- schedule --------------------------------------------------------------

    def schedule_ts(self, n_steps: int) -> np.ndarray:
        """(n_steps - 1, 2) fp32 (from, to) sigma pairs."""
        return edm_schedule_ts(n_steps, self.constants)

    def _ts(self, ts, batch: Optional[int] = None) -> torch.Tensor:
        ts = torch.as_tensor(ts, dtype=torch.float32, device=self.device).reshape(-1)
        if batch is not None and ts.shape[0] == 1 and batch > 1:
            ts = ts.expand(batch)
        return ts

    @staticmethod
    def sigmas(ts) -> torch.Tensor:
        """(N, 1, 1, 1) fp32 sigmas, on `ts`'s device (the CPU for a number
        or an array)."""
        return torch.atleast_1d(torch.as_tensor(ts, dtype=torch.float32))[:, None, None, None]

    @staticmethod
    def alphas(ts) -> torch.Tensor:
        return torch.ones_like(MonsterDiffusion.sigmas(ts))

    def training_ts(self, size: int, generator: torch.Generator) -> torch.Tensor:
        """log-normal training sigmas, exp(P_mean + P_std N(0, 1))."""
        c = self.constants
        noise = torch.randn((size,), generator=generator, device=self.device)
        return torch.exp(c.P_mean + noise * c.P_std)

    def random_noise(self, size: int, generator: torch.Generator) -> torch.Tensor:
        """`size` images at sigma_max, in [0, 1] image space."""
        noise = torch.randn((size, *self.shape), generator=generator, device=self.device)
        return diffusion_space.decode(noise * self.constants.sigma_max)

    def diffuse(self, images, ts, noise=None, generator: Optional[torch.Generator] = None):
        """q-sample: x0 + sigma * noise, the noise given or from `generator`."""
        x0 = diffusion_space.encode(images)
        if noise is None:
            if generator is None:
                raise ValueError("diffuse is stochastic: pass noise= or generator=")
            noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        return diffusion_space.decode(x0 + noise * self.sigmas(self._ts(ts)))

    # -- the preconditioned net --------------------------------------------------

    def denoised_(self, diffused_images, ts, nonleaky_augmentations=None) -> torch.Tensor:
        """The denoised xs: c_skip x + c_out net(c_in x, c_noise, augmentations)."""
        n = diffused_images.shape[0]
        sigmas = self.sigmas(self._ts(ts, n))
        c_skip, c_out, c_in, c_noise = edm_preconditioning(sigmas, self.constants)
        xs = diffusion_space.encode(diffused_images)
        if nonleaky_augmentations is None:
            nonleaky_augmentations = torch.zeros((n, N_AUGMENTATIONS), device=xs.device)
        output = self.module(c_in * xs, c_noise.reshape(-1), nonleaky_augmentations)
        return c_skip * xs + c_out * output

    def predictions(self, diffused_images, ts, nonleaky_augmentations=None) -> EDMPredictions:
        ts = self._ts(ts, diffused_images.shape[0])
        return EDMPredictions(
            denoised_xs=self.denoised_(diffused_images, ts, nonleaky_augmentations),
            diffused_images=diffused_images,
            ts=ts,
        )

    forward = predictions

    # -- churn ---------------------------------------------------------------------

    def gamma(self, ts, n_steps: int) -> torch.Tensor:
        """min(S_churn / n_steps, sqrt 2 - 1) where S_tmin <= sigma <= S_tmax."""
        c, ts = self.constants, self._ts(ts)
        churn = min(c.S_churn / n_steps, float(np.sqrt(2) - 1))
        return torch.where((ts >= c.S_tmin) & (ts <= c.S_tmax), churn, 0.0)

    def reversed_ts(self, ts, n_steps: int) -> torch.Tensor:
        ts = self._ts(ts)
        return ts + self.gamma(ts, n_steps) * ts

    def inject_noise(self, diffused_images, ts, reversed_ts,
                     generator: Optional[torch.Generator] = None, noise=None) -> torch.Tensor:
        """Renoise from `ts` up to `reversed_ts`, S_noise times the added
        sigma; the noise given or from `generator`."""
        xs = diffusion_space.encode(diffused_images)
        fresh = base.randn_like(xs, generator) if noise is None else noise
        added = torch.sqrt(torch.square(self.sigmas(reversed_ts)) - torch.square(self.sigmas(ts)))
        return diffusion_space.decode(xs + added * fresh * self.constants.S_noise)

    # -- samplers --------------------------------------------------------------------

    def _start(self, size, generator, diffused_images):
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if diffused_images is None:
            diffused_images = self.random_noise(size, generator)
        return generator, diffused_images

    def _final(self, images, ts) -> torch.Tensor:
        return torch.clamp(self.predictions(images, ts).denoised_images, 0, 1)

    @torch.no_grad()
    def sample(self, size: int, n_evaluations: int = 100,
               generator: Optional[torch.Generator] = None, diffused_images=None):
        """The elucidated stochastic sampler: over n_evaluations // 2
        sigmas, churn up, an Euler step and Heun's correction (two
        evaluations a pair), then a churned final denoise. Images in [0, 1];
        `generator` defaults to one seeded 0 on the model's device."""
        generator, images = self._start(size, generator, diffused_images)
        n_steps = n_evaluations // 2
        pairs = torch.as_tensor(self.schedule_ts(n_steps), device=self.device)
        for from_t, to_t in pairs:
            from_ts, to_ts = from_t.expand(size), to_t.expand(size)
            reversed_ts = torch.clamp(self.reversed_ts(from_ts, n_steps),
                                      max=self.constants.sigma_max)
            reversed_images = self.inject_noise(images, from_ts, reversed_ts, generator)
            predictions = self.predictions(reversed_images, reversed_ts)
            reversed_eps = predictions.eps
            images = predictions.step(to_ts)
            images = self.predictions(images, to_ts).heun_correction(
                reversed_images, reversed_ts, reversed_eps)
        to_ts = pairs[-1, 1].expand(size)
        reversed_ts = self.reversed_ts(to_ts, n_steps)
        return self._final(self.inject_noise(images, to_ts, reversed_ts, generator), reversed_ts)

    elucidated_sample = sample

    @torch.no_grad()
    def dpm_solver_sample(self, size: int, n_evaluations: int = 100,
                          generator: Optional[torch.Generator] = None, diffused_images=None):
        """DPM-Solver++(2M), deterministic: one evaluation a step over
        n_evaluations sigmas, then the final denoise. `generator` draws the
        start only."""
        _, images = self._start(size, generator, diffused_images)
        pairs = torch.as_tensor(self.schedule_ts(n_evaluations), device=self.device)
        prev_x0 = torch.zeros_like(images)
        prev_h = torch.ones((size, 1, 1, 1), device=self.device, dtype=images.dtype)
        for i, (from_t, to_t) in enumerate(pairs):
            predictions = self.predictions(images, from_t.expand(size))
            images, prev_h = predictions.dpm_solver_pp_step(to_t.expand(size), prev_x0, prev_h,
                                                            i == 0)
            prev_x0 = predictions.denoised_xs
        return self._final(images, pairs[-1, 1].expand(size))

    @staticmethod
    def linear_multistep_coeff(order, sigmas, from_index, to_index) -> float:
        """The LMS coefficient: the Lagrange basis polynomial of `to_index`
        over the last `order` sigmas, integrated over the step (scipy
        quadrature on the host)."""
        from scipy import integrate

        if order - 1 > from_index:
            raise ValueError(f"Order {order} too high for step {from_index}")

        def fn(tau):
            prod = 1.0
            for k in range(order):
                if to_index == k:
                    continue
                prod *= (tau - sigmas[from_index - k]) / (
                    sigmas[from_index - to_index] - sigmas[from_index - k]
                )
            return prod

        return integrate.quad(fn, sigmas[from_index], sigmas[from_index + 1], epsrel=1e-4)[0]

    @torch.no_grad()
    def linear_multistep_sample(self, size: int, n_evaluations: int = 100,
                                generator: Optional[torch.Generator] = None,
                                diffused_images=None, order: int = 4):
        """Linear multistep over n_evaluations sigmas (order up to `order`,
        coefficients from the host), then the final denoise. `generator`
        draws the start only."""
        _, images = self._start(size, generator, diffused_images)
        sigmas = edm_sigmas(n_evaluations, self.constants)
        epses = []
        for from_index in range(n_evaluations - 1):
            epses.append(self.predictions(images, sigmas[from_index]).eps)
            current_order = min(from_index + 1, order)
            coeffs = [self.linear_multistep_coeff(current_order, sigmas, from_index, k)
                      for k in range(current_order)]
            delta = sum(coeff * eps for coeff, eps in zip(coeffs, reversed(epses[-current_order:])))
            images = diffusion_space.decode(diffusion_space.encode(images) + delta)
            del epses[:-order]
        return self._final(images, sigmas[-1])
