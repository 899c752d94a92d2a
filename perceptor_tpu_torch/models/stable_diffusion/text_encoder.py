"""CLIP text encoder for SD conditioning (counterpart of
perceptor_tpu/models/stable_diffusion/text_encoder.py).

The CLIP ViT-L/14 text tower of SD v1.x: token and positional embeddings,
the pre-LN transformer of models/clip/model.py (quick GELU) under a causal
mask, then `ln_final`. The UNet is conditioned on the whole (N, 77, 768)
hidden-state sequence, not the pooled embedding. Attention is masked, so it
always takes the plain dot-product route (`ops/attention.flash_route`).

Token ids must lie in [0, vocab_size): out-of-range ids raise a ValueError
(JAX's gather would clamp them silently, and a CUDA gather would fault).
"""

from __future__ import annotations

import torch
from torch import nn

from perceptor_tpu_torch.models.clip.model import Transformer, checked_token_ids
from perceptor_tpu_torch.models.stable_diffusion.config import TextConfig
from perceptor_tpu_torch.ops.attention import causal_mask
from perceptor_tpu_torch.ops.layers import LayerNorm


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: TextConfig):
        super().__init__()
        self.config = config
        self.token_embedding = nn.Embedding(config.vocab_size, config.width)
        self.positional_embedding = nn.Parameter(torch.empty(config.context_length, config.width))
        self.transformer = Transformer(config.width, config.layers, config.heads, quick=True)
        self.ln_final = LayerNorm(config.width, eps=1e-5)

    def forward(self, tokens) -> torch.Tensor:
        """tokens (N, S) integer ids -> hidden states (N, S, width) fp32."""
        weight = self.token_embedding.weight
        tokens = checked_token_ids(tokens, self.config.vocab_size, weight.device)
        seq = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:seq].to(weight.dtype)
        x = self.transformer(x, causal_mask(seq, device=weight.device))
        return self.ln_final(x)
