"""GuidedDiffusion wrapper: OpenAI ADM, "standard" 512px / "pixelart" 256px
(counterpart of perceptor_tpu/models/guided_diffusion/guided_diffusion.py).

  - the linear-beta DDPM schedule as alpha/sigma tables on the device;
  - Karras-rho `schedule_indices` snapped to the 1000-index grid;
  - `predictions()` -> IndexedEpsPredictions from the UNet output's first
    three channels (the model learns sigma too; those heads are dropped);
  - `diffuse_images` (q-sample) and `random_diffused`;
  - `sample()`: unconditional images by DDIM (`eta` for the stochastic
    variant) or DPM-Solver++(2M), img2img with `init_images` + `from_index`.

Diffused images are in [0, 1] at this boundary (x-space is [-1, 1]). Where
JAX compiles the sampler into one `lax.scan` program, here `sample_loop` is
an eager Python loop over the schedule pairs. Randomness comes from an
explicit `torch.Generator`.

Weights are seeded random at the published widths (the tree holds no
checkpoints), stored in bf16 for matmuls and convolutions when `fp16`;
`load_state_dict` takes real (OpenAI-named) or converted weights
(`convert.adm_state_dict_from_jax`).

Not ported (ROADMAP queue A): `mesh`/`rules` and checkpoint discovery.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.guided_diffusion import config as adm_config
from perceptor_tpu_torch.models.guided_diffusion.unet import ADMUNet
from perceptor_tpu_torch.predictions import IndexedEpsPredictions, diffusion_space
from perceptor_tpu_torch.schedules import indexed_schedule, linear_alphas_sigmas
from perceptor_tpu_torch.utils import serving
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

METHODS = ("ddim", "dpm++")


class GuidedDiffusion:
    def __init__(self, name: str = "standard", fp16: bool = True, device="cuda", seed: int = 0,
                 remat: bool = False):
        """`name` is a key of `config.MODEL_CONFIGS` (standard: the 512px
        ImageNet finetune; pixelart; tiny); `fp16` stores matmul/conv
        weights in bf16 (bf16 compute); weights come from the checkpoint that
        `find_checkpoint("guided_diffusion_<name>", name)` finds
        (`utils.checkpoints.load_found`), else they are random from `seed`;
        `device` is CUDA unless the caller passes "cpu"; `remat` recomputes
        the UNet's res and attention blocks in the backward pass."""
        if name not in adm_config.MODEL_CONFIGS:
            raise ValueError(f"Unknown model name {name}")
        self.name = name
        self.config = dataclasses.replace(adm_config.MODEL_CONFIGS[name], remat=remat)
        self.shape = adm_config.SHAPES[name]
        self.device = resolve_device(device)
        self.dtype = COMPUTE_DTYPE if fp16 else torch.float32
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(ADMUNet, self.config, self.device, gen, self.dtype)
        alphas, sigmas = linear_alphas_sigmas()
        self.schedule_alphas = torch.as_tensor(alphas, device=self.device)
        self.schedule_sigmas = torch.as_tensor(sigmas, device=self.device)
        path = find_checkpoint(f"guided_diffusion_{name}", name)
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self.load_state_dict)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import adm_state_dict_from_jax

        return {"module": adm_state_dict_from_jax(params, self.config)}

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules whose tensors `params` lists, by the same names."""
        return {"module": self.module}

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"module": the UNet's parameters and buffers by name}: the weights
        argument of the exported programs."""
        return {"module": serving.module_params(self.module)}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load an OpenAI-named ADM state_dict; the module keeps its storage
        dtypes (bf16 matmul weights when `fp16`)."""
        self.module.load_state_dict(state_dict)
        if self.dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.module)

    # -- schedule ------------------------------------------------------------

    def schedule_indices(
        self, n_steps: int = 500, from_index: int = 999, to_index: int = 0, rho: float = 7.0
    ) -> np.ndarray:
        """(k, 2) (from, to) index pairs snapped to the linear-beta grid,
        k <= n_steps."""
        return indexed_schedule(
            self.schedule_alphas.cpu().numpy(),
            self.schedule_sigmas.cpu().numpy(),
            n_steps=n_steps,
            from_index=from_index,
            to_index=to_index,
            rho=rho,
            strict=False,
        )

    def random_diffused(self, shape, generator: torch.Generator) -> torch.Tensor:
        """(N, C, H, W) pure-noise start, in [0, 1] image space."""
        if shape[2] % 8 or shape[3] % 8:
            raise ValueError("Height and width must be divisible by 8")
        noise = torch.randn(tuple(shape), generator=generator, device=self.device)
        return diffusion_space.decode(noise)

    def _indices(self, indices, batch: Optional[int] = None) -> torch.Tensor:
        indices = torch.as_tensor(indices, device=self.device)
        if indices.ndim == 0:
            indices = indices[None]
        if batch is not None and indices.shape[0] == 1 and batch > 1:
            indices = indices.expand(batch)
        return indices.long()

    def alphas(self, indices) -> torch.Tensor:
        return self.schedule_alphas[self._indices(indices)][:, None, None, None]

    def sigmas(self, indices) -> torch.Tensor:
        return self.schedule_sigmas[self._indices(indices)][:, None, None, None]

    # -- model ---------------------------------------------------------------

    def predicted_noise(self, diffused_images, from_indices) -> torch.Tensor:
        """UNet forward, eps channels only."""
        indices = self._indices(from_indices, diffused_images.shape[0])
        out = self.module(diffusion_space.encode(diffused_images), indices.float())
        return out[:, :3]

    def predictions(self, diffused_images, indices, conditioning=None) -> IndexedEpsPredictions:
        """eps predictions at schedule `indices`. ADM is unconditional:
        `conditioning` (the argument `engine.guided_sample` passes) must be
        None."""
        if conditioning is not None:
            raise ValueError("GuidedDiffusion is unconditional")
        indices = self._indices(indices, diffused_images.shape[0])
        return IndexedEpsPredictions(
            from_diffused_images=diffused_images,
            from_indices=indices,
            predicted_noise=self.predicted_noise(diffused_images, indices),
            schedule_alphas=self.schedule_alphas,
            schedule_sigmas=self.schedule_sigmas,
        )

    forward = predictions

    def diffuse_images(self, denoised_images, indices, noise=None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """q-sample: alpha * x0 + sigma * noise in x-space, back in [0, 1]."""
        xs = diffusion_space.encode(denoised_images)
        if noise is None:
            if generator is None:
                raise ValueError("diffuse_images is stochastic: pass noise= or generator=")
            noise = torch.randn(xs.shape, generator=generator, device=xs.device, dtype=xs.dtype)
        return diffusion_space.decode(xs * self.alphas(indices) + noise * self.sigmas(indices))

    # -- samplers ------------------------------------------------------------

    @torch.no_grad()
    def sample(
        self,
        n_images: int = 1,
        n_steps: int = 50,
        size: Optional[Tuple[int, int]] = None,
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        from_index: int = 999,
        to_index: int = 0,
        rho: float = 3.0,
        init_images=None,
        method: str = "ddim",
    ) -> torch.Tensor:
        """Images (N, 3, H, W) in [0, 1], fp32: per schedule pair one
        prediction and a DDIM step (stochastic for `eta > 0`) or, with
        `method="dpm++"`, a DPM-Solver++(2M) step (deterministic), then the
        denoised images at the last index. `init_images` + `from_index <
        999` gives img2img. `generator` defaults to one seeded 0 on the
        model's device."""
        self._check_method(method, eta)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        size = size if size is not None else self.shape[1:]
        pairs = self.schedule_indices(n_steps, from_index=from_index, to_index=to_index, rho=rho)
        if init_images is None:
            diffused = self.random_diffused((n_images, 3, *size), generator)
        else:
            init_images = torch.as_tensor(init_images, dtype=torch.float32, device=self.device)
            diffused = self.diffuse_images(init_images, int(pairs[0, 0]), generator=generator)
        return self.sample_loop(diffused, pairs, eta=eta, generator=generator, method=method)

    @staticmethod
    def _check_method(method: str, eta) -> None:
        if method not in METHODS:
            raise ValueError(f"unknown sampling method: {method!r}")
        if method == "dpm++" and float(eta) > 0.0:
            raise ValueError("dpm++ is deterministic: eta does not apply")

    @torch.no_grad()
    def sample_loop(self, diffused, pairs, eta: float = 0.0,
                    generator: Optional[torch.Generator] = None, method: str = "ddim"):
        """The sampler from given diffused images: one UNet evaluation per
        (from, to) pair of `pairs` and one more for the denoised images at
        the last index."""
        self._check_method(method, eta)
        n = diffused.shape[0]
        pairs = torch.as_tensor(np.asarray(pairs), device=self.device).long()
        prev_x0 = torch.zeros_like(diffused)
        prev_h = torch.ones((n, 1, 1, 1), device=self.device)
        for i in range(pairs.shape[0]):
            predictions = self.predictions(diffused, pairs[i, 0].expand(n))
            to_idx = pairs[i, 1].expand(n)
            if method == "dpm++":
                diffused, prev_h = predictions.dpm_solver_pp_step(to_idx, prev_x0, prev_h, i == 0)
                prev_x0 = predictions.denoised_xs
            else:
                diffused = predictions.step(to_idx, eta=eta, generator=generator)
        return self.predictions(diffused, pairs[-1, 1].expand(n)).denoised_images
