"""GLIDE's noise-aware CLIP (counterpart of
perceptor_tpu/models/glide_clip.py), NCHW.

Two towers with GLIDE's checkpoint names (glide_text2im/clip/encoders.py,
one state_dict each): `blocks.input` (the text tower's `w_voc` / `w_pos`;
the image tower's `patch_proj`, `w_pos`, timestep table `w_t` and `ln`),
`blocks.block_{i}.f_attn.{ln, f_q, f_k, f_v, f_c}` and
`blocks.block_{i}.f_mlp.{ln, f_1, f_2}` (pre-LN, K without a bias, exact
GELU), `blocks.output.{ln, f}`; LayerNorms hold `g` / `b`, projections `w`
(out, in) / `b`. The JAX package's `convert_glide_text` and
`convert_glide_image` read these state_dicts. The towers compute in bf16
with fp32 LayerNorms.

The image tower takes [0, 255] images normalized by CLIP's channel moments
and a timestep token `w_t[t]` put first, pools token 0; the text tower pools
at `len - 1`. `GlideCLIP.encode_images(diffused, ts)` maps a diffused image
in [0, 1] (resized to 64) to the tower's input; `encode_texts` truncates to
77 ids, pads with 0 and takes the ids modulo `n_vocab`, as the JAX wrapper
does. Both return L2-normalized encodings. 257 image tokens: the plain
attention route.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import init_random_, resolve_device
from perceptor_tpu_torch.losses.prompt_bank import _l2_normalize
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer
from perceptor_tpu_torch.models.dual_encoder import _generator, _precision_dtype
from perceptor_tpu_torch.ops.attention import causal_mask, dot_product_attention
from perceptor_tpu_torch.ops.resize import resize
from perceptor_tpu_torch.utils.cache import cache

CHANNEL_MEANS = (122.77093945, 116.74601272, 104.09373519)
CHANNEL_STDS = (68.50053285, 66.63215831, 70.32316309)


@dataclasses.dataclass(frozen=True)
class GlideCLIPConfig:
    image_size: int = 64
    patch_size: int = 4
    n_vocab: int = 65536
    max_text_len: int = 77
    n_embd: int = 512
    text_heads: int = 8
    text_blocks: int = 12
    image_heads: int = 12
    image_blocks: int = 12
    head_state: int = 64
    n_timestep: int = 1000
    logit_scale: float = 100.0


TINY = GlideCLIPConfig(
    image_size=32, patch_size=16, n_vocab=64, max_text_len=16, n_embd=16,
    text_heads=2, text_blocks=2, image_heads=2, image_blocks=2, head_state=8,
    n_timestep=10,
)
CONFIGS = {"default": GlideCLIPConfig(), "tiny": TINY}


class _LayerNorm(nn.Module):
    """GLIDE's LayerNorm (`g`, `b`), computed and returned in fp32."""

    def __init__(self, n_state: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(n_state))
        self.b = nn.Parameter(torch.zeros(n_state))

    def forward(self, x):
        return F.layer_norm(x.float(), self.g.shape, self.g.float(), self.b.float(), 1e-5)


class _Affine(nn.Module):
    """GLIDE's Affine: `w` (out, in), optional `b`; computes in `w`'s dtype."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_out, n_in))
        self.b = nn.Parameter(torch.zeros(n_out)) if bias else None

    def forward(self, x):
        b = None if self.b is None else self.b.to(self.w.dtype)
        return F.linear(x.to(self.w.dtype), self.w, b)


class _Attention(nn.Module):
    def __init__(self, n_state: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.ln = _LayerNorm(n_state)
        self.f_q = _Affine(n_state, n_state)
        self.f_k = _Affine(n_state, n_state, bias=False)
        self.f_v = _Affine(n_state, n_state)
        self.f_c = _Affine(n_state, n_state)

    def forward(self, x):
        b, s, d = x.shape
        h = self.ln(x)

        def split(t):
            return t.reshape(b, s, self.heads, d // self.heads).transpose(1, 2)

        mask = causal_mask(s, device=x.device) if self.causal else None
        out = dot_product_attention(split(self.f_q(h)), split(self.f_k(h)), split(self.f_v(h)),
                                    mask=mask)
        return self.f_c(out.transpose(1, 2).reshape(b, s, d))


class _MLP(nn.Module):
    def __init__(self, n_state: int):
        super().__init__()
        self.ln = _LayerNorm(n_state)
        self.f_1 = _Affine(n_state, n_state * 4)
        self.f_2 = _Affine(n_state * 4, n_state)

    def forward(self, x):
        return self.f_2(F.gelu(self.f_1(self.ln(x))))


class _GlideBlock(nn.Module):
    def __init__(self, n_state: int, heads: int, causal: bool):
        super().__init__()
        self.f_attn = _Attention(n_state, heads, causal)
        self.f_mlp = _MLP(n_state)

    def forward(self, x):
        x = x + self.f_attn(x)
        return x + self.f_mlp(x)


class _Output(nn.Module):
    def __init__(self, n_state: int, n_embd: int):
        super().__init__()
        self.ln = _LayerNorm(n_state)
        self.f = _Affine(n_state, n_embd, bias=False)

    def forward(self, pooled):
        return self.f(self.ln(pooled)).float()


class _TextInput(nn.Module):
    def __init__(self, cfg: GlideCLIPConfig, n_state: int):
        super().__init__()
        self.w_voc = nn.Parameter(torch.empty(cfg.n_vocab, n_state))
        self.w_pos = nn.Parameter(torch.empty(cfg.max_text_len, n_state))

    def forward(self, tokens):
        return self.w_voc[tokens] + self.w_pos[None]


class _ImageInput(nn.Module):
    def __init__(self, cfg: GlideCLIPConfig, n_state: int):
        super().__init__()
        self.patch_size = cfg.patch_size
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_proj = nn.Parameter(torch.empty(n_state, 3, cfg.patch_size, cfg.patch_size))
        self.w_pos = nn.Parameter(torch.empty(1 + n_patches, n_state))
        self.w_t = nn.Parameter(torch.empty(cfg.n_timestep, n_state))
        self.ln = _LayerNorm(n_state)
        self.register_buffer("means", torch.empty(1, 3, 1, 1), persistent=False)
        self.register_buffer("stds", torch.empty(1, 3, 1, 1), persistent=False)
        self.reset_buffers()

    def reset_buffers(self) -> None:
        if self.means.device.type != "meta":
            self.means.copy_(torch.tensor(CHANNEL_MEANS).reshape(1, 3, 1, 1))
            self.stds.copy_(torch.tensor(CHANNEL_STDS).reshape(1, 3, 1, 1))

    def forward(self, images, timesteps):
        """images (N, 3, H, W) in [0, 255], timesteps (N,) ints -> the
        normalized token sequence in the tower's dtype."""
        dtype = self.patch_proj.dtype
        x = ((images - self.means) / self.stds).to(dtype)
        x = F.conv2d(x, self.patch_proj, stride=self.patch_size).flatten(2).transpose(1, 2)
        x = torch.cat([self.w_t[timesteps][:, None].to(dtype), x], dim=1)
        return self.ln(x + self.w_pos[None].to(dtype)).to(dtype)


class _Tower(nn.Module):
    def __init__(self, cfg: GlideCLIPConfig, n_state: int, heads: int, n_blocks: int,
                 causal: bool, inputs: nn.Module):
        super().__init__()
        blocks = {"input": inputs}
        blocks.update({f"block_{i}": _GlideBlock(n_state, heads, causal) for i in range(n_blocks)})
        blocks["output"] = _Output(n_state, cfg.n_embd)
        self.blocks = nn.ModuleDict(blocks)

    def run_blocks(self, x):
        for name, block in self.blocks.items():
            if name.startswith("block_"):
                x = block(x)
        return x


class GlideTextEncoder(_Tower):
    def __init__(self, cfg: GlideCLIPConfig):
        n_state = cfg.text_heads * cfg.head_state
        super().__init__(cfg, n_state, cfg.text_heads, cfg.text_blocks, True,
                         _TextInput(cfg, n_state))

    def forward(self, tokens, text_lens):
        """tokens (N, max_text_len) ids, text_lens (N,) -> (N, n_embd), fp32."""
        x = self.run_blocks(self.blocks["input"](tokens))
        return self.blocks["output"](x[torch.arange(x.shape[0], device=x.device), text_lens - 1])


class GlideImageEncoder(_Tower):
    def __init__(self, cfg: GlideCLIPConfig):
        n_state = cfg.image_heads * cfg.head_state
        super().__init__(cfg, n_state, cfg.image_heads, cfg.image_blocks, False,
                         _ImageInput(cfg, n_state))

    def forward(self, images, timesteps):
        """images (N, 3, H, W) in [0, 255], timesteps (N,) -> (N, n_embd), fp32."""
        x = self.run_blocks(self.blocks["input"](images, timesteps))
        return self.blocks["output"](x[:, 0])


@torch.no_grad()
def _random_tower(cls, cfg, device, generator, dtype) -> nn.Module:
    """`cls(cfg)` filled as `init_by_shape` fills JAX's tower: LayerNorm
    scales one and biases zero, every other tensor normal with std
    1/sqrt(fan_in), where a projection's `w` (out, in) and the patch
    projection (out, in, p, p) take their fan-in from the input dims (which
    `init_random_` reads from the leading dims of a param not named
    `weight`); frozen, bf16 storage when `dtype` is the compute dtype."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to_empty(device=device)
    init_random_(module, generator)
    for sub in module.modules():
        if isinstance(sub, _LayerNorm):
            sub.g.fill_(1.0)
            sub.b.zero_()
        elif isinstance(sub, _Affine):
            sub.w.mul_(math.sqrt(sub.w.shape[0] / sub.w.shape[1]))
            if sub.b is not None:
                sub.b.zero_()
        elif isinstance(sub, _ImageInput):
            proj = sub.patch_proj
            proj.mul_(math.sqrt(np.prod(proj.shape[:-1]) / np.prod(proj.shape[1:])))
    if dtype == COMPUTE_DTYPE:
        cast_matmul_params_bf16(module)
    return module.requires_grad_(False).eval()


@cache
class GlideCLIP:
    def __init__(
        self,
        name: str = "default",
        tokenizer: Optional[SimpleTokenizer] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        """GLIDE's CLIP trained on noisy images: `encode_images(diffused,
        ts)`, `encode_texts(prompts)`. Both towers frozen on `device` (CUDA
        unless the caller passes "cpu"), random weights from `seed`, matmul
        weights in bf16 unless `precision="fp32"`; memoized on its
        arguments."""
        if name not in CONFIGS:
            raise ValueError(f"unknown glide clip config: {name}")
        cfg = CONFIGS[name]
        self.name = name
        self.config = cfg
        self.logit_scale = cfg.logit_scale
        self.device = resolve_device(device)
        self.dtype = _precision_dtype(precision)
        generator = _generator(seed, self.device)
        self.text_encoder = _random_tower(GlideTextEncoder, cfg, self.device, generator, self.dtype)
        self.image_encoder = _random_tower(GlideImageEncoder, cfg, self.device, generator,
                                           self.dtype)
        self._tokenizer = tokenizer

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    def load_state_dicts(self, text: Mapping[str, torch.Tensor],
                         image: Mapping[str, torch.Tensor]) -> None:
        """GLIDE's clip_text_enc and clip_image_enc state_dicts."""
        for module, state_dict in ((self.text_encoder, text), (self.image_encoder, image)):
            module.load_state_dict(state_dict)
            if self.dtype == COMPUTE_DTYPE:
                cast_matmul_params_bf16(module)

    @torch.no_grad()
    def encode_texts(self, text_prompts: List[str]) -> torch.Tensor:
        """Pooled at each prompt's last token; (N, n_embd), unit norm."""
        cfg = self.config
        rows, lens = [], []
        for prompt in text_prompts:
            ids = self.tokenizer.encode(prompt)[: cfg.max_text_len]
            lens.append(max(len(ids), 1))
            rows.append(ids + [0] * (cfg.max_text_len - len(ids)))
        tokens = torch.as_tensor(np.asarray(rows, np.int64) % cfg.n_vocab, device=self.device)
        lens = torch.as_tensor(lens, device=self.device)
        return _l2_normalize(self.text_encoder(tokens, lens))

    def encode_images(self, diffused: torch.Tensor, ts) -> torch.Tensor:
        """diffused (N, 3, H, W) in [0, 1] at timesteps `ts` (an int or
        (N,) ints) -> (N, n_embd), unit norm; differentiable in `diffused`."""
        size = (self.config.image_size, self.config.image_size)
        if tuple(diffused.shape[-2:]) != size:
            diffused = resize(diffused, out_shape=size)
        images = (diffused * 2.0 - 1.0 + 1.0) * 127.5
        ts = torch.atleast_1d(torch.as_tensor(ts, device=self.device)).long()
        return _l2_normalize(self.image_encoder(images, ts))
