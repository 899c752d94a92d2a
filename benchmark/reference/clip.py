"""Plain CLIP towers in float32.

- `CLIPTextModel`: Stable Diffusion v1's text encoder, under Hugging Face
  `transformers` names (`text_model.embeddings.token_embedding`, ...,
  `text_model.encoder.layers.{i}.self_attn.q_proj`, ...,
  `text_model.final_layer_norm`); its output is the last hidden state after
  the final LayerNorm, (N, 77, hidden_size). Configuration keys are those of
  the model's `text_encoder/config.json`.
- `OpenCLIP`: OpenAI's CLIP (ViT image tower and text tower) under
  open_clip's names (`visual.conv1`, `visual.class_embedding`,
  `visual.transformer.resblocks.{i}.attn.in_proj_weight`, ...,
  `token_embedding`, `transformer.resblocks.{i}`, `ln_final`,
  `text_projection`, `logit_scale`). Only the image tower runs.

Both are pre-LN transformers; OpenAI's weights use quick GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    Conv2d, Fp8Mixin, Linear, attention, causal_mask, quick_gelu,
)


def _act(name: str):
    return quick_gelu if name == "quick_gelu" else F.gelu


class CLIPAttention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(width, width), Linear(width, width)
        self.v_proj, self.out_proj = Linear(width, width), Linear(width, width)

    def forward(self, x, mask):
        b, s, w = x.shape

        def heads(t):
            return t.reshape(b, s, self.heads, w // self.heads).transpose(1, 2)

        out = attention(heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x)),
                        mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, w))


class CLIPMLP(nn.Module):
    def __init__(self, width, inner, act):
        super().__init__()
        self.act = _act(act)
        self.fc1, self.fc2 = Linear(width, inner), Linear(inner, width)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        width, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.self_attn = CLIPAttention(width, cfg["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)
        self.mlp = CLIPMLP(width, cfg["intermediate_size"], cfg["hidden_act"])

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _TextModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        width = cfg["hidden_size"]
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], width)
        self.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], width)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg["num_hidden_layers"])])
        self.final_layer_norm = nn.LayerNorm(width, eps=cfg["layer_norm_eps"])


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.text_model = _TextModel(cfg)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        m = self.text_model
        seq = tokens.shape[1]
        x = m.embeddings.token_embedding(tokens) + m.embeddings.position_embedding.weight[:seq]
        mask = causal_mask(seq, tokens.device)
        for layer in m.encoder.layers:
            x = layer(x, mask)
        return m.final_layer_norm(x)


class MultiheadAttention(Fp8Mixin, nn.Module):
    """nn.MultiheadAttention's parameters: packed q, k, v."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)

    @property
    def weight(self):
        return self.in_proj_weight

    def forward(self, x):
        b, s, w = x.shape
        x_in, weight = self._operands(x)
        q, k, v = self._output(F.linear(x_in, weight, self.in_proj_bias)).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(b, s, self.heads, w // self.heads).transpose(1, 2)

        out = attention(heads(q), heads(k), heads(v))
        return self.out_proj(out.transpose(1, 2).reshape(b, s, w))


class _OpenClipMLP(nn.Module):
    def __init__(self, width, act):
        super().__init__()
        self.act = _act(act)
        self.c_fc, self.c_proj = Linear(width, 4 * width), Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(self.act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, act):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = _OpenClipMLP(width, act)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def _transformer(width, layers, heads, act):
    t = nn.Module()
    t.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads, act)
                                 for _ in range(layers)])
    return t


class VisionTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        width, patch = cfg["vision_width"], cfg["patch_size"]
        grid = cfg["image_size"] // patch
        self.conv1 = Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = _transformer(width, cfg["vision_layers"], cfg["vision_heads"],
                                        cfg["hidden_act"])
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, cfg["embed_dim"]))

    def forward(self, images):
        x = self.conv1(images).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_post(x[:, 0]) @ self.proj


class OpenCLIP(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.visual = VisionTransformer(cfg)
        width = cfg["text_width"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg["context_length"], width))
        self.transformer = _transformer(width, cfg["text_layers"], cfg["text_heads"],
                                        cfg["hidden_act"])
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, cfg["embed_dim"]))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)
