"""OpenCLIP wrapper: one text/image encoder API (counterpart of
perceptor_tpu/models/open_clip.py).

  - `encode_images(images)`: differentiable resize to the tower's native
    resolution, CLIP normalization, the image tower, L2-normalized output;
  - `encode_texts(texts)`: BPE tokenize and the text tower, L2-normalized;
  - `encode_tokens(tokens)`: the text tower on given token ids;
  - `spherical_distance(a, b)`: pairwise squared spherical distance.

The towers are one frozen `models/clip/model.py CLIP` module on `device`
(CUDA unless the caller passes "cpu"), its matmul weights stored in bf16
unless `precision="fp32"`. Weights are seeded random at the published
widths (`core/init.py random_module`: the tree holds no checkpoints and
checkpoint discovery is not ported); `load_state_dict` takes real or
converted weights (`convert.clip_state_dict_from_jax`). The wrapper is
memoized on its arguments (`utils/cache.py`), so two losses that name the
same tower share it.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.clip import configs as clip_configs
from perceptor_tpu_torch.models.clip.model import CLIP as CLIPModule
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.utils.cache import cache

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


@cache
class OpenCLIP:
    def __init__(
        self,
        architecture: str = "ViT-H-14",
        weights: str = "laion2b_s32b_b79k",
        precision: Optional[str] = None,
        config: Optional[clip_configs.CLIPConfig] = None,
        tokenizer: Optional[SimpleTokenizer] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        """`config` overrides the (architecture, weights) lookup;
        `precision` None, "fp16" or "bf16" stores matmul weights in bf16,
        anything else in fp32; `seed` is an int or a `torch.Generator` on
        `device` whose stream the random weights continue."""
        self.architecture = architecture
        self.weights = weights
        self.config = config or clip_configs.get_config(architecture, weights)
        self.device = resolve_device(device)
        self.dtype = COMPUTE_DTYPE if precision in (None, "fp16", "bf16") else torch.float32
        if not isinstance(seed, torch.Generator):
            seed = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(CLIPModule, self.config, self.device, seed, self.dtype)
        self._tokenizer = tokenizer
        self._mean = torch.as_tensor(CLIP_MEAN, device=self.device).reshape(1, 3, 1, 1)
        self._std = torch.as_tensor(CLIP_STD, device=self.device).reshape(1, 3, 1, 1)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load an open_clip-named state_dict; the module keeps its storage
        dtypes (bf16 matmul weights unless `precision="fp32"`)."""
        self.module.load_state_dict(state_dict)
        if self.dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.module)

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    @property
    def image_size(self):
        return self.config.image_size

    @torch.no_grad()
    def encode_texts(self, text_prompts, normalize: bool = True) -> torch.Tensor:
        tokens = tokenize(text_prompts, self.config.context_length, tokenizer=self.tokenizer)
        return self.encode_tokens(tokens, normalize)

    @torch.no_grad()
    def encode_tokens(self, tokens, normalize: bool = True) -> torch.Tensor:
        encodings = self.module.encode_text(tokens)
        return _l2_normalize(encodings) if normalize else encodings

    def encode_images(self, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """Differentiable in `images`, (N, 3, H, W) in [0, 1] on the
        wrapper's device: resize -> normalize -> tower."""
        images = resize(images, out_shape=self.config.image_size)
        images = (images - self._mean) / self._std
        encodings = self.module.encode_image(images)
        return _l2_normalize(encodings) if normalize else encodings

    @staticmethod
    def spherical_distance(encodings_a, encodings_b) -> torch.Tensor:
        """Pairwise squared spherical distance, (len(a), len(b))."""
        diff_norm = torch.linalg.norm(encodings_a[:, None] - encodings_b[None, :], dim=2)
        return torch.square(torch.arcsin(diff_norm / 2)) * 2
