"""OWL-ViT text-conditioned detection (counterpart of
perceptor_tpu/models/owlvit.py), NCHW.

Names are HF `OwlViTForObjectDetection`'s: `owlvit.vision_model.*` and
`owlvit.text_model.*` (CLIP towers: pre-LN layers, quick-GELU),
`owlvit.text_projection`, the merge `layer_norm`, `class_head.*` and
`box_head.*`, so an HF state_dict loads (`OWLViT.load_state_dict` drops
the CLIP head it does not use) and the JAX package's `convert_owlvit` reads
the port's. The towers compute in bf16 with fp32 LayerNorms; the merged
patch features and both heads are fp32, as JAX's undtyped `nn.Dense`s. The
merged features are the patch tokens times the class token, normalized;
the class head divides by `norm + 1e-6` and scales by `elu(x) + 1`; the box
head is an exact-GELU MLP plus a fixed bias of the patch grid, built once per
(patches, device).

B/32 at 768px attends over 577 tokens: the plain attention route.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import keep_fp32
from perceptor_tpu_torch.models.clip.tokenizer import SimpleTokenizer, tokenize
from perceptor_tpu_torch.models.dual_encoder import DualEncoder
from perceptor_tpu_torch.ops.attention import attention, causal_mask
from perceptor_tpu_torch.ops.layers import Conv2d, LayerNorm, Linear
from perceptor_tpu_torch.utils.cache import cache

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class OWLViTConfig:
    image_size: int = 768
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    vocab_size: int = 49408
    context_length: int = 16
    embed_dim: int = 512  # text hidden size == class-head out_dim


TINY = OWLViTConfig(
    image_size=64, patch_size=32, vision_width=32, vision_layers=2,
    vision_heads=2, text_width=32, text_heads=2, text_layers=2, vocab_size=64,
    context_length=8, embed_dim=32,
)
CONFIGS = {"google/owlvit-base-patch32": OWLViTConfig(), "tiny": TINY}


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(width, width), Linear(width, width)
        self.v_proj, self.out_proj = Linear(width, width), Linear(width, width)

    def forward(self, x, mask=None):
        b, s, w = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, w // self.heads).transpose(1, 2)

        out = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)),
                        mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, w))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(width, width * 4), Linear(width * 4, width)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class _CLIPLayer(nn.Module):
    """HF CLIP encoder layer: pre-LN (fp32), quick-GELU; the residual stream
    in the towers' dtype."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(width, eps=1e-5)
        self.self_attn = _Attention(width, heads)
        self.layer_norm2 = LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(width, heads) for _ in range(layers)])

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embedding = Conv2d(3, cfg.vision_width, cfg.patch_size, stride=cfg.patch_size,
                                      bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.vision_width))
        self.position_embedding = nn.Embedding(n_patches + 1, cfg.vision_width)

    def forward(self, images):
        x = self.patch_embedding(images).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight.to(x.dtype)


class OWLViTVision(nn.Module):
    """Returns the post-LN sequence (class token + patches), fp32."""

    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layernorm = LayerNorm(cfg.vision_width, eps=1e-5)
        self.encoder = _Encoder(cfg.vision_width, cfg.vision_heads, cfg.vision_layers)
        self.post_layernorm = LayerNorm(cfg.vision_width, eps=1e-5)

    def forward(self, images):
        x = self.embeddings(images)
        x = self.encoder(self.pre_layernorm(x).to(x.dtype))
        return self.post_layernorm(x)


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.text_width)

    def forward(self, tokens):
        return self.token_embedding(tokens) + self.position_embedding.weight[: tokens.shape[1]]


class OWLViTText(nn.Module):
    """The CLIP text tower, pooled at each row's largest id (the end of
    text), fp32."""

    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg.text_width, cfg.text_heads, cfg.text_layers)
        self.final_layer_norm = LayerNorm(cfg.text_width, eps=1e-5)

    def forward(self, tokens):
        x = self.embeddings(tokens)
        mask = causal_mask(tokens.shape[1], device=tokens.device)
        x = self.final_layer_norm(self.encoder(x, mask))
        return x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]


class _CLIP(nn.Module):
    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        self.vision_model = OWLViTVision(cfg)
        self.text_model = OWLViTText(cfg)
        self.text_projection = Linear(cfg.text_width, cfg.embed_dim, bias=False)


class _ClassHead(nn.Module):
    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        self.dense0 = keep_fp32(Linear(cfg.vision_width, cfg.embed_dim))
        self.logit_shift = keep_fp32(Linear(cfg.vision_width, 1))
        self.logit_scale = keep_fp32(Linear(cfg.vision_width, 1))


class _BoxHead(nn.Module):
    def __init__(self, cfg: OWLViTConfig):
        super().__init__()
        self.dense0 = keep_fp32(Linear(cfg.vision_width, cfg.vision_width))
        self.dense1 = keep_fp32(Linear(cfg.vision_width, cfg.vision_width))
        self.dense2 = keep_fp32(Linear(cfg.vision_width, 4))


@functools.lru_cache(maxsize=16)
def box_bias(n_patches: int, device: torch.device) -> torch.Tensor:
    """The box head's bias over an n x n patch grid, (n^2, 4): the inverse
    sigmoid of each patch's (x, y) corner and of its size 1 / n, computed in
    numpy float32 and copied to `device` once."""
    coords = np.arange(1, n_patches + 1, dtype=np.float32) / n_patches
    xx, yy = np.meshgrid(coords, coords, indexing="xy")
    xy = np.clip(np.stack([xx, yy], axis=-1).reshape(-1, 2), 0.0, 1.0)
    coord_bias = np.log(xy + 1e-4) - np.log1p(-xy + 1e-4)
    size = np.full_like(xy, 1.0 / n_patches)
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return torch.as_tensor(np.concatenate([coord_bias, size_bias], axis=-1), device=device)


class OWLViTDetection(nn.Module):
    def __init__(self, config: OWLViTConfig):
        super().__init__()
        self.config = config
        self.owlvit = _CLIP(config)
        self.layer_norm = LayerNorm(config.vision_width, eps=1e-5)
        self.class_head = _ClassHead(config)
        self.box_head = _BoxHead(config)

    def encode_queries(self, tokens):
        """(Q, ctx) ids -> (Q, embed_dim) query embeddings, fp32."""
        return self.owlvit.text_projection(self.owlvit.text_model(tokens)).float()

    def image_features(self, images):
        """Merged patch features, (N, P, W) fp32: each patch token times the
        class token, then the merge LayerNorm."""
        embeds = self.owlvit.vision_model(images)
        return self.layer_norm(embeds[:, 1:] * embeds[:, :1])

    def forward(self, images, query_tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized images and (Q, ctx) query ids -> (logits (N, P, Q),
        boxes (N, P, 4) as cxcywh in [0, 1])."""
        cfg = self.config
        feats = self.image_features(images)
        queries = self.encode_queries(query_tokens)
        class_embeds = self.class_head.dense0(feats)
        class_embeds = class_embeds / (torch.linalg.norm(class_embeds, dim=-1, keepdim=True) + 1e-6)
        queries = queries / (torch.linalg.norm(queries, dim=-1, keepdim=True) + 1e-6)
        logits = torch.einsum("npd,qd->npq", class_embeds, queries)
        shift = self.class_head.logit_shift(feats)
        scale = F.elu(self.class_head.logit_scale(feats)) + 1
        logits = (logits + shift) * scale
        h = F.gelu(self.box_head.dense0(feats))
        h = F.gelu(self.box_head.dense1(h))
        boxes = self.box_head.dense2(h)
        boxes = torch.sigmoid(boxes + box_bias(cfg.image_size // cfg.patch_size, feats.device))
        return logits, boxes


@dataclasses.dataclass
class OWLViTEncodings:
    tokens: torch.Tensor  # (Q, ctx)
    texts: tuple = ()


@dataclasses.dataclass
class OWLViTPredictions:
    logits: torch.Tensor  # (N, P, Q)
    boxes: torch.Tensor  # (N, P, 4) xyxy pixels
    scores: torch.Tensor  # (N, P)
    labels: torch.Tensor  # (N, P)
    texts: tuple = ()


# HF OwlViTModel keys the detector does not use
_UNUSED_KEYS = ("owlvit.visual_projection.weight", "owlvit.logit_scale")


@cache
class OWLViT(DualEncoder):
    _FAMILY = "owlvit"

    def _checkpoint_names(self):
        return (f"owlvit_{self.name.replace('/', '_')}", self.name)

    def __init__(
        self,
        name: str = "google/owlvit-base-patch32",
        tokenizer: Optional[SimpleTokenizer] = None,
        precision: Optional[str] = None,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        """The detector `name` (CONFIGS), frozen on `device` (CUDA unless
        the caller passes "cpu") with the weights of the checkpoint that
        `find_checkpoint("owlvit_<name with / as _>", name)` finds, else
        random from `seed`, its tower
        weights stored in bf16 unless `precision="fp32"`; memoized on its
        arguments."""
        if name not in CONFIGS:
            raise ValueError(f"unknown owlvit model: {name}")
        self.name = name
        self._build(OWLViTDetection, CONFIGS[name], precision, device, seed, IMAGE_MEAN,
                    IMAGE_STD)
        self.size = (self.config.image_size, self.config.image_size)
        self._tokenizer = tokenizer

    @property
    def tokenizer(self) -> SimpleTokenizer:
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """An HF OwlViTForObjectDetection state_dict; the CLIP head's
        `visual_projection` and `logit_scale` and the `position_ids` buffers
        are dropped."""
        super().load_state_dict({k: v for k, v in state_dict.items()
                                 if k not in _UNUSED_KEYS and not k.endswith("position_ids")})

    def encode_texts(self, texts: List[List[str]]) -> OWLViTEncodings:
        """One flat query list from the groups of `texts`, tokenized at the
        config's context length (EOT kept on truncation)."""
        flat = [t for group in texts for t in group]
        tokens = tokenize(flat, self.config.context_length, tokenizer=self.tokenizer)
        return OWLViTEncodings(tokens=torch.as_tensor(tokens, device=self.device),
                               texts=tuple(tuple(group) for group in texts))

    def forward(self, images, encodings: OWLViTEncodings) -> OWLViTPredictions:
        """images (N, 3, H, W) in [0, 1], resized to the config's size and
        normalized -> predictions per patch: logits, sigmoid scores and
        argmax labels over the queries, boxes as xyxy pixels. Differentiable
        in `images`."""
        logits, boxes = self.module(self.normalize(images, self.size), encodings.tokens)
        probs = torch.sigmoid(logits)
        scores, labels = probs.max(dim=-1)
        h, w = self.size
        cx, cy, bw, bh = boxes.unbind(-1)
        xyxy = torch.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                            (cx + bw / 2) * w, (cy + bh / 2) * h], dim=-1)
        return OWLViTPredictions(logits=logits, boxes=xyxy, scores=scores, labels=labels,
                                 texts=encodings.texts)

    __call__ = forward
