"""VelocityDiffusion wrapper: yfcc_2 / yfcc_1 / cc12m_1_cfg / wikiart
(counterpart of perceptor_tpu/models/velocity_diffusion/velocity_diffusion.py).

  - the continuous-t cosine schedule and Karras-rho `schedule_ts`;
  - `velocities()` (the UNet forward) and `predictions()` ->
    VelocityPredictions;
  - CLIP `conditioning()` for the conditioned cc12m model;
  - `diffuse` (q-sample) and `inject_noise` (reverse-renoising);
  - `sample()`: DDIM (`eta`, `churn`, `correction`), the PNDM pair "plms" /
    "prk", or DPM-Solver++(2M); `reverse_sample()`: DDIM inversion.

Diffused images are in [0, 1] at this boundary (x-space is [-1, 1]). Where
JAX compiles each sampler into one `lax.scan` program, here they are eager
Python loops (`sample_loop` runs one from given diffused images).
Randomness comes from an explicit `torch.Generator`.

Weights are seeded random at the published widths (the tree holds no
checkpoints), stored in bf16 for matmuls and convolutions when `fp16`;
`load_state_dict` takes converted weights (`convert.vnet_state_dict_from_jax`);
the constructor loads the checkpoint that `utils.checkpoints.find_checkpoint`
finds. `export_sample` traces the sampler into a `torch.export` program.
`sample(mesh=, rules=)` samples with the weights placed on a DeviceMesh by
the tensor-parallel rules (`parallel.partition.sampling`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.velocity_diffusion import configs, pndm
from perceptor_tpu_torch.models.velocity_diffusion.net import VDiffusionUNet
from perceptor_tpu_torch.predictions import VelocityPredictions, diffusion_space
from perceptor_tpu_torch.predictions.base import NoiseStream
from perceptor_tpu_torch.schedules import sigma_to_t, t_to_alpha_sigma, velocity_schedule_ts
from perceptor_tpu_torch.utils import serving
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

METHODS = ("ddim", "plms", "prk", "dpm++")


class VelocityDiffusion:
    def __init__(self, name: str = "yfcc_2", fp16: bool = True, device="cuda", seed: int = 0,
                 remat: bool = False):
        """`name` is a key of `configs.MODEL_CONFIGS` (yfcc_2, yfcc_1,
        cc12m_1_cfg (CLIP-conditioned), wikiart, tiny, tiny_conditioned);
        `fp16` stores matmul/conv weights in bf16 (bf16 compute); weights
        are those of the checkpoint `find_checkpoint("velocity_diffusion_<name>", name)`
        finds (`utils.checkpoints.load_found`), else random from `seed`; `device` is CUDA unless the caller passes
        "cpu"; `remat` recomputes the UNet's conv blocks in the backward
        pass."""
        if name not in configs.MODEL_CONFIGS:
            raise ValueError(f"unknown velocity diffusion model: {name}")
        self.name = name
        self.config = dataclasses.replace(configs.MODEL_CONFIGS[name], remat=remat)
        self.device = resolve_device(device)
        self.seed = seed
        self.dtype = COMPUTE_DTYPE if fp16 else torch.float32
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(VDiffusionUNet, self.config, self.device, gen, self.dtype)
        path = find_checkpoint(f"velocity_diffusion_{name}", name)
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self.load_state_dict)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import vnet_state_dict_from_jax

        return {"module": vnet_state_dict_from_jax(params, self.config)}

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules whose tensors `params` lists, by the same names."""
        return {"module": self.module}

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"module": the UNet's parameters and buffers by name}: the weights
        argument of the exported programs."""
        return {"module": serving.module_params(self.module)}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load a state_dict of `VDiffusionUNet`; the module keeps its
        storage dtypes (bf16 matmul weights when `fp16`)."""
        self.module.load_state_dict(state_dict)
        if self.dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.module)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.config.in_channels, *self.config.image_size)

    @property
    def conditioned(self) -> bool:
        return self.config.mapping is not None

    # -- schedules (host-side) -----------------------------------------------

    @staticmethod
    def schedule_ts(n_steps=500, from_ts=1.0, to_ts=1e-2, rho=7.0) -> np.ndarray:
        """(n_steps, 2) fp32 (from_t, to_t) pairs."""
        return velocity_schedule_ts(n_steps, from_ts, to_ts, rho)

    @staticmethod
    def sigmas_to_ts(sigmas):
        return sigma_to_t(sigmas)

    def _ts(self, ts, batch: Optional[int] = None) -> torch.Tensor:
        ts = torch.as_tensor(ts, dtype=torch.float32, device=self.device)
        if ts.ndim == 0:
            ts = ts.expand(batch) if batch is not None else ts[None]
        return ts

    def alphas(self, ts) -> torch.Tensor:
        return t_to_alpha_sigma(self._ts(ts))[0][:, None, None, None]

    def sigmas(self, ts) -> torch.Tensor:
        return t_to_alpha_sigma(self._ts(ts))[1][:, None, None, None]

    def random_diffused(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Pure-noise start, in [0, 1] image space."""
        return diffusion_space.decode(
            torch.randn(tuple(shape), generator=generator, device=self.device)
        )

    # -- network ---------------------------------------------------------------

    def _clip_embed(self, conditioning, batch: Optional[int] = None):
        """(N, D) embeddings from (N, D) or a stacked (1, N, D); one
        embedding serves a whole batch."""
        if conditioning is None:
            return None
        clip_embed = torch.as_tensor(conditioning, device=self.device)
        if clip_embed.ndim == 3:
            clip_embed = clip_embed.squeeze(0)
        if batch is not None and clip_embed.shape[0] == 1 and batch > 1:
            clip_embed = clip_embed.expand(batch, clip_embed.shape[1])
        return clip_embed

    def velocities(self, diffused_images, ts, conditioning=None) -> torch.Tensor:
        """UNet forward on images in [0, 1] at times `ts`."""
        ts = self._ts(ts, diffused_images.shape[0])
        xs = diffusion_space.encode(diffused_images)
        if conditioning is None:
            return self.module(xs, ts)
        return self.module(xs, ts, self._clip_embed(conditioning))

    def predictions(self, diffused_images, ts, conditioning=None) -> VelocityPredictions:
        ts = self._ts(ts, diffused_images.shape[0])
        return VelocityPredictions(
            from_diffused_images=diffused_images,
            from_ts=ts,
            velocities=self.velocities(diffused_images, ts, conditioning),
        )

    forward = predictions

    @torch.no_grad()
    def conditioning(self, texts=None, images=None, encodings=None) -> torch.Tensor:
        """Mean of CLIP text / image / raw encodings, (1, N, D)."""
        from perceptor_tpu_torch import models

        if not self.conditioned:
            raise ValueError(f"{self.name} takes no conditioning")
        clip_model = models.CLIP(self.config.mapping.clip_model, device=self.device, seed=self.seed)
        all_encodings = []
        if texts is not None:
            all_encodings.append(clip_model.encode_texts(texts).float())
        if images is not None:
            all_encodings.append(clip_model.encode_images(images).float())
        if encodings is not None:
            all_encodings.append(
                torch.as_tensor(encodings, dtype=torch.float32, device=self.device)
            )
        if not all_encodings:
            raise ValueError("Must provide at least one of texts, images, encodings")
        return torch.stack(all_encodings, dim=0).mean(dim=0)[None]

    # -- diffusion utilities ----------------------------------------------------

    def diffuse(self, denoised_images, ts, noise=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """q-sample."""
        xs = diffusion_space.encode(denoised_images)
        if noise is None:
            if generator is None:
                raise ValueError("diffuse() is stochastic: pass noise= or generator=")
            noise = torch.randn(xs.shape, generator=generator, device=xs.device, dtype=xs.dtype)
        return diffusion_space.decode(xs * self.alphas(ts) + noise * self.sigmas(ts))

    def inject_noise(self, diffused_images, ts, reversed_ts, generator: Optional[torch.Generator],
                     extra_noise_multiplier: float = 1.003, noise=None) -> torch.Tensor:
        """Reverse-renoise to a higher t; the noise from `generator`, or
        given as `noise`."""
        xs = diffusion_space.encode(diffused_images)
        multiplier = self.alphas(reversed_ts) / self.alphas(ts)
        additional_std = torch.sqrt(
            torch.square(self.sigmas(reversed_ts))
            - torch.square(self.sigmas(ts)) * torch.square(multiplier)
        )
        if noise is None:
            if generator is None:
                raise ValueError("inject_noise() is stochastic: pass generator= or noise=")
            noise = torch.randn(xs.shape, generator=generator, device=xs.device, dtype=xs.dtype)
        return diffusion_space.decode(
            xs * multiplier + additional_std * noise * extra_noise_multiplier
        )

    # -- samplers -------------------------------------------------------------

    @torch.no_grad()
    def sample(
        self,
        n_images: int = 1,
        n_steps: int = 50,
        conditioning=None,
        eta: float = 0.0,
        churn: float = 0.0,
        correction: bool = False,
        generator: Optional[torch.Generator] = None,
        from_ts: float = 1.0,
        to_ts: float = 1e-2,
        mesh=None,
        rules=None,
        method: str = "ddim",
    ) -> torch.Tensor:
        """Images (n_images, *self.shape) in [0, 1], fp32.

        `method="ddim"`: per schedule pair, optional stochastic
        reverse-renoise churn (toward `from_t * (1 + churn)`), a DDIM step
        (stochastic for `eta > 0`) and the optional `correction`
        (re-evaluate at the stepped point, average the two denoised
        estimates, re-step). "plms" / "prk" are the deterministic PNDM
        samplers, "dpm++" DPM-Solver++(2M); eta / churn / correction apply
        to ddim only. A conditioned model sampled without `conditioning`
        gets the zero embedding of its unconditional branch. `generator`
        defaults to one seeded 0 on the model's device. `mesh` / `rules` as
        in `GuidedDiffusion.sample` (`parallel.partition.sampling`)."""
        self._check_method(method, eta, churn, correction)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        diffused = self.random_diffused((n_images, *self.shape), generator)
        pairs = self.schedule_ts(n_steps, from_ts=from_ts, to_ts=to_ts)
        options = dict(eta=eta, churn=churn, correction=correction, generator=generator,
                       method=method)
        if mesh is None:
            return self.sample_loop(diffused, pairs, conditioning, **options)
        from perceptor_tpu_torch.parallel.partition import sampling

        with sampling(mesh, self.serving_modules(), diffused, rules) as run:
            return run.gather(self.sample_loop(run.latents, pairs, run.rows(conditioning),
                                               **options))

    @staticmethod
    def _check_method(method, eta, churn, correction) -> None:
        if method not in METHODS:
            raise ValueError(f"unknown sampling method: {method!r}")
        if method != "ddim" and (eta or churn or correction):
            raise ValueError(f"{method} is deterministic: eta/churn/correction do not apply")

    def _eps_fn(self, cond):
        """Noise-prediction closure over xs in diffusion space:
        eps = x sigma + v alpha."""

        def eps_fn(xs, ts):
            v = self.velocities(diffusion_space.decode(xs), ts, cond)
            alphas, sigmas = t_to_alpha_sigma(ts)
            return xs * pndm._broadcast(sigmas, xs) + v * pndm._broadcast(alphas, xs)

        return eps_fn

    @torch.no_grad()
    def sample_loop(
        self,
        diffused,
        pairs,
        conditioning=None,
        eta: float = 0.0,
        churn: float = 0.0,
        correction: bool = False,
        generator: Optional[torch.Generator] = None,
        method: str = "ddim",
    ) -> torch.Tensor:
        """`sample()` from given diffused images over the (n_steps, 2)
        (from_t, to_t) `pairs`."""
        self._check_method(method, eta, churn, correction)
        n = diffused.shape[0]
        pairs = torch.as_tensor(pairs if isinstance(pairs, torch.Tensor) else np.asarray(pairs),
                                dtype=torch.float32, device=self.device)
        cond = self._clip_embed(conditioning, n)
        if self.conditioned and cond is None:
            cond = torch.zeros((n, self.config.mapping.clip_dim), device=self.device)

        if method in ("plms", "prk"):
            # the descending time sequence with the trailing 0 appended
            ts = torch.cat([pairs[:, 0], pairs[-1:, 1], pairs.new_zeros(1)])
            sampler = pndm.plms_sample if method == "plms" else pndm.prk_sample
            _, pred = sampler(self._eps_fn(cond), diffusion_space.encode(diffused), ts)
            return diffusion_space.decode(pred)

        def predict(diffused, ts):
            return self.predictions(diffused, ts, cond)

        if method == "dpm++":
            prev_x0 = torch.zeros_like(diffused)
            prev_h = torch.ones((n, 1, 1, 1), device=self.device)
            for i in range(pairs.shape[0]):
                predictions = predict(diffused, pairs[i, 0].expand(n))
                diffused, prev_h = predictions.dpm_solver_pp_step(
                    pairs[i, 1].expand(n), prev_x0, prev_h, i == 0
                )
                prev_x0 = predictions.denoised_xs
            return predict(diffused, pairs[-1, 1].expand(n)).denoised_images

        for i in range(pairs.shape[0]):
            from_t, to_t = pairs[i, 0].expand(n), pairs[i, 1].expand(n)
            if isinstance(churn, torch.Tensor) or churn > 0.0:
                # renoise toward from_t * (1 + churn) where from_t < 1
                new_from = torch.clamp(from_t * (1.0 + churn), max=1.0)
                renoised = predict(diffused, from_t).noisy_reverse_step(new_from, generator)
                below = from_t < 1.0
                diffused = torch.where(below[:, None, None, None], renoised, diffused)
                from_t = torch.where(below, new_from, from_t)
            predictions = predict(diffused, from_t)
            stepped = predictions.step(to_t, eta=eta, generator=generator)
            if correction:
                corrected = predict(stepped, to_t).correction(predictions)
                stepped = corrected.step(to_t, eta=eta, generator=generator)
            diffused = stepped
        return predict(diffused, pairs[-1, 1].expand(n)).denoised_images

    @staticmethod
    def sample_noise_shape(n_images: int, shape, n_steps: int, eta: float = 0.0,
                           churn: float = 0.0, correction: bool = False) -> Tuple[int, ...]:
        """The shape of `export_sample`'s `noise` argument: (draws, n_images,
        *shape), one draw per step for the churn and, with eta > 0, one per
        DDIM step and one per correction re-step; draw it with
        `predictions.base.draw_noise` from the generator `sample_loop` would
        use to get its numbers."""
        per_step = (float(churn) > 0.0) + ((1 + bool(correction)) if float(eta) > 0.0 else 0)
        return (n_steps * per_step, n_images, *shape)

    def export_sample(self, n_images: int = 1, n_steps: int = 50, eta: float = 0.0,
                      churn: float = 0.0, correction: bool = False, platforms=None) -> bytes:
        """The DDIM sampler as a `torch.export` program (utils/serving.py),
        as bytes. Its signature is `(params, diffused, pairs, conditioning,
        noise, eta, churn) -> images`: `params` is `self.params`, `pairs`
        the (n_steps, 2) fp32 schedule, `conditioning` the (n_images,
        clip_dim) CLIP embedding of a conditioned checkpoint (None
        otherwise), `noise` the pre-drawn step noise of `sample_noise_shape`
        (empty when nothing is drawn), `eta` and `churn` 0-d fp32 tensors.
        Whether eta and churn are above 0, and `correction`, are baked in;
        the step loop is unrolled into the graph."""
        stochastic, do_churn = float(eta) > 0.0, float(churn) > 0.0
        noise_shape = self.sample_noise_shape(n_images, self.shape, n_steps, eta, churn,
                                              correction)

        @torch.no_grad()
        def run(diffused, pairs, conditioning, noise, eta_arg, churn_arg):
            return self.sample_loop(
                diffused, pairs, conditioning, eta=eta_arg if stochastic else 0.0,
                churn=churn_arg if do_churn else 0.0, correction=correction,
                generator=NoiseStream(noise) if noise_shape[0] else None,
            )

        def serve(params, diffused, pairs, conditioning, noise, eta_arg, churn_arg):
            return serving.functional(self.serving_modules(), params, run, diffused, pairs,
                                      conditioning, noise, eta_arg, churn_arg)

        cond = (torch.zeros((n_images, self.config.mapping.clip_dim), device=self.device)
                if self.conditioned else None)
        example = (
            self.params,
            torch.zeros((n_images, *self.shape), device=self.device),
            torch.as_tensor(self.schedule_ts(n_steps), dtype=torch.float32, device=self.device),
            cond,
            torch.zeros(noise_shape, device=self.device),
            torch.tensor(float(eta), device=self.device),
            torch.tensor(float(churn), device=self.device),
        )
        return serving.serialize_program(serve, *example, platforms=platforms)

    @torch.no_grad()
    def reverse_sample(self, images, n_steps: int = 50, conditioning=None,
                       from_ts: float = 1e-2, to_ts: float = 1.0) -> torch.Tensor:
        """DDIM inversion: the diffused images at `to_ts`, in [0, 1], that
        eta = 0 sampling decodes back into `images`."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        cond = self._clip_embed(conditioning, images.shape[0])
        pairs = self.schedule_ts(n_steps, from_ts=to_ts, to_ts=from_ts)[::-1]
        # ascending sequence: the reversed pairs' to-times, then the last from-time
        ts = np.concatenate([pairs[:, 1], pairs[-1:, 0]])
        xs = pndm.ddim_reverse_sample(self._eps_fn(cond), diffusion_space.encode(images), ts)
        return diffusion_space.decode(xs)
