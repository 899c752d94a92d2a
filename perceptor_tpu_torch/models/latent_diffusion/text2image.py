"""LDM Text2Image, CompVis txt2img-f8-large (1.4B) (counterpart of
perceptor_tpu/models/latent_diffusion/text2image.py).

A spatial-transformer ADM UNet (`TXT2IMG_UNET`) over 4-channel f8 latents
of the KL first stage (the port's SD `AutoencoderKL` with the LDM scale
factor), conditioned on the BERT encoder's states; classifier-free guidance
is built into `eps()` in the JAX order: the positive prompts first in one
batched UNet call, `negative + g * (positive - negative)`. `sample()` runs
the shared LDM loop (`ddim.py`), DDIM with eta or DPM-Solver++(2M), eagerly
where JAX compiles one `lax.scan` program.

Weights are seeded random at the published widths (the tree holds no
checkpoint and no BERT vocabulary: pass `tokenizer=` or place
bert-base-uncased-vocab.txt where `bert._VOCAB_PATHS` looks), stored in bf16
for matmuls and convolutions when `fp16`; `load_state_dicts` takes
port-named state_dicts (`convert.text2image_state_dicts_from_jax`; an
original CompVis checkpoint's `model.diffusion_model.*` and
`cond_stage_model.transformer.*` keys are the UNet's and BERT's names, and
`first_stage.convert_compvis_autoencoder` maps its `first_stage_model.*`);
the constructor loads the checkpoint that `utils.checkpoints.find_checkpoint`
finds. `sample(mesh=, rules=)` samples with the weights placed on a DeviceMesh by
the tensor-parallel rules (`parallel.partition.sampling`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.guided_diffusion.unet import ADMUNet
from perceptor_tpu_torch.models.latent_diffusion import bert as bert_lib
from perceptor_tpu_torch.models.latent_diffusion.ddim import LatentDiffusionSchedule, check_method
from perceptor_tpu_torch.models.stable_diffusion.config import SD_V1_VAE, TINY_VAE
from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found, strip_prefix

# txt2img-1p4B-eval.yaml model.params: the LDM "linear" schedule is linear
# in sqrt(beta) space, SD's scaled-linear
TIMESTEPS = 1000
LINEAR_START = 0.00085
LINEAR_END = 0.012
SCALE_FACTOR = 0.18215

TXT2IMG_UNET = ADMConfig(
    image_size=32,
    model_channels=320,
    channel_mult=(1, 2, 4, 4),
    num_res_blocks=2,
    attention_ds=(1, 2, 4),
    num_heads=8,
    in_channels=4,
    out_channels=4,
    spatial_transformer=True,
    context_dim=1280,
)

TINY_UNET = ADMConfig(
    image_size=8,
    model_channels=16,
    channel_mult=(1, 2),
    num_res_blocks=1,
    attention_ds=(2,),
    num_heads=2,
    in_channels=4,
    out_channels=4,
    spatial_transformer=True,
    context_dim=32,
)


class Text2Image(LatentDiffusionSchedule):
    def __init__(
        self,
        guidance_scale: Optional[float] = 5.0,
        eta: float = 0.0,
        fp16: bool = True,
        tiny: bool = False,
        tokenizer: Optional[bert_lib.BERTTokenizer] = None,
        device="cuda",
        seed: int = 0,
    ):
        """`tiny` picks the test widths; `fp16` stores matmul/conv weights
        in bf16 (bf16 compute); weights come from the checkpoint that
        `find_checkpoint("latent_diffusion_text2image", "txt2img-1p4B")`
        finds (`utils.checkpoints.load_found`; a CompVis file through the
        first-stage key map), else they are random from `seed`; `device` is
        CUDA unless the caller passes "cpu"."""
        self.guidance_scale = guidance_scale
        self.eta = eta
        self.device = resolve_device(device)
        dtype = COMPUTE_DTYPE if fp16 else torch.float32
        self.unet_config = TINY_UNET if tiny else TXT2IMG_UNET
        self.bert_config = bert_lib.TINY_BERT if tiny else bert_lib.BERTConfig()
        self.vae_config = dataclasses.replace(TINY_VAE if tiny else SD_V1_VAE,
                                              scaling_factor=SCALE_FACTOR)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.unet = random_module(ADMUNet, self.unet_config, self.device, gen, dtype)
        self.first_stage = random_module(AutoencoderKL, self.vae_config, self.device, gen, dtype)
        self.bert = random_module(bert_lib.BERTEncoder, self.bert_config, self.device, gen, dtype)
        self._tokenizer = tokenizer
        self._set_schedule(LINEAR_START, LINEAR_END)
        path = find_checkpoint("latent_diffusion_text2image", "txt2img-1p4B")
        if path is not None:
            load_found(path, self.serving_modules(), self._from_jax, self._load_upstream)

    def serving_modules(self) -> Dict[str, torch.nn.Module]:
        """The modules a checkpoint fills, by name."""
        return {key: getattr(self, key) for key in ("unet", "first_stage", "bert")}

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import text2image_state_dicts_from_jax

        return text2image_state_dicts_from_jax(params, self.unet_config, self.vae_config,
                                               self.bert_config)

    def _load_upstream(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """A CompVis checkpoint: the UNet under `model.diffusion_model.`, the
        KL first stage under `first_stage_model.` (CompVis names), BERT
        under `cond_stage_model.transformer.`."""
        from perceptor_tpu_torch.models.latent_diffusion.first_stage import (
            convert_compvis_autoencoder,
        )

        self.load_state_dicts({
            "unet": strip_prefix(state_dict, "model.diffusion_model."),
            "first_stage": convert_compvis_autoencoder(state_dict, self.vae_config),
            "bert": strip_prefix(state_dict, "cond_stage_model.transformer."),
        })

    def load_state_dicts(self, state_dicts: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Load {"unet", "first_stage", "bert"} state_dicts (each module
        keeps its own storage dtypes)."""
        for key in ("unet", "first_stage", "bert"):
            getattr(self, key).load_state_dict(state_dicts[key])

    @property
    def tokenizer(self) -> bert_lib.BERTTokenizer:
        if self._tokenizer is None:
            self._tokenizer = bert_lib.BERTTokenizer(max_length=self.bert_config.max_seq_len)
        return self._tokenizer

    # -- the reference's API -------------------------------------------------

    def latent_shape(self, height, width):
        down = self.vae_config.downscale
        return [self.vae_config.latent_channels, height // down, width // down]

    def random_latents(self, images_shape, generator: torch.Generator) -> torch.Tensor:
        return torch.randn((images_shape[0], *self.latent_shape(*images_shape[-2:])),
                           generator=generator, device=self.device)

    def latents(self, images, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [0, 1] -> scaled first-stage latents: the posterior's mode,
        or a sample from `generator`."""
        return self.first_stage.encode(images, generator)

    @torch.no_grad()
    def conditioning(self, text_prompts: Sequence[str],
                     negative_text_prompts: Sequence[str] = ("",)) -> torch.Tensor:
        """cat([positive, negative]) BERT encodings, fp32."""
        tokens = self.tokenizer(list(text_prompts) + list(negative_text_prompts))
        return self.bert(torch.from_numpy(tokens))

    def _eps(self, latents, index, conditioning, guidance_scale):
        n = latents.shape[0]
        ts = torch.full((n,), float(index), device=latents.device)
        if guidance_scale is None or guidance_scale == 1.0:
            return self.unet(latents, ts, conditioning[:n])
        positive, negative = conditioning[:n], conditioning[n:]
        stacked = self.unet(
            torch.cat([latents, latents]), torch.cat([ts, ts]),
            torch.cat([positive, negative.expand_as(positive)]),
        )
        eps_positive, eps_negative = stacked.chunk(2)
        return eps_negative + guidance_scale * (eps_positive - eps_negative)

    def eps(self, latents, index, conditioning):
        """Noise prediction with the built-in CFG at `guidance_scale`;
        `conditioning` is `conditioning()`'s cat([positive, negative])."""
        if index >= 1000:
            raise ValueError("index must be less than 1000")
        return self._eps(latents, index, conditioning, self.guidance_scale)

    def denoise(self, latents, index, conditioning=None, eps=None):
        if eps is None:
            eps = self.eps(latents, index, conditioning)
        return self._denoised(latents, index, eps)

    forward = denoise

    def images(self, latents) -> torch.Tensor:
        """Latents -> images [0, 1], fp32."""
        return self.first_stage.decode(latents)

    # -- the sampler ---------------------------------------------------------

    @torch.no_grad()
    def sample(
        self,
        texts: Sequence[str],
        negative_texts: Sequence[str] = ("",),
        n_steps: int = 50,
        size=(256, 256),
        guidance_scale: Optional[float] = None,
        eta: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        from_index: int = 999,
        to_index: int = 50,
        mesh=None,
        rules=None,
        method: str = "ddim",
    ) -> torch.Tensor:
        """Texts -> images (N, 3, H, W) in [0, 1]: per schedule pair eps
        with the built-in CFG -> denoise -> DDIM step (or DPM-Solver++(2M),
        deterministic: no eta), then the final denoise and the decode.
        `guidance_scale` and `eta` default to the constructor's;
        `generator` to one seeded 0 on the model's device. `mesh` / `rules`
        as in `GuidedDiffusion.sample` (`parallel.partition.sampling`)."""
        eta = self.eta if eta is None else eta
        check_method(method, eta)
        generator = self._generator(generator)
        latents = self.random_latents((len(texts), 3, *size), generator)
        cond = self.conditioning(list(texts), list(negative_texts))
        pairs = self.schedule_indices(from_index, to_index, n_steps)
        if mesh is None:
            return self.sample_loop(latents, pairs, cond, guidance_scale, eta, generator, method)
        from perceptor_tpu_torch.parallel.partition import sampling

        with sampling(mesh, self.serving_modules(), latents, rules) as run:
            positive, negative = cond.chunk(2)
            cond = torch.cat([run.rows(positive), run.rows(negative)])
            return run.gather(self.sample_loop(run.latents, pairs, cond, guidance_scale, eta,
                                               generator, method))

    @torch.no_grad()
    def sample_loop(self, latents, pairs, conditioning, guidance_scale: Optional[float] = None,
                    eta: Optional[float] = None, generator: Optional[torch.Generator] = None,
                    method: str = "ddim") -> torch.Tensor:
        """The sampler from given latents and `conditioning()`'s encodings:
        k schedule pairs are k + 1 (batched CFG) UNet evaluations and one
        decode."""
        guidance_scale = self.guidance_scale if guidance_scale is None else guidance_scale
        eta = self.eta if eta is None else eta
        check_method(method, eta)
        return self._sample_loop(
            latents, pairs,
            lambda x, index: self._eps(x, index, conditioning, guidance_scale),
            self.images, eta, generator, method,
        )
