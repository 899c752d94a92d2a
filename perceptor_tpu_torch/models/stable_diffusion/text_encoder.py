"""CLIP text encoder for SD conditioning (counterpart of
perceptor_tpu/models/stable_diffusion/text_encoder.py).

The CLIP ViT-L/14 text tower of SD v1.x: token and positional embeddings,
the pre-LN transformer of models/clip/model.py (quick GELU) under a causal
mask, then `ln_final`. The UNet is conditioned on the whole (N, 77, 768)
hidden-state sequence, not the pooled embedding. Attention is masked, so it
always takes the plain dot-product route (`ops/attention.flash_route`).

SDXL's two towers (CLIP ViT-L/14 and OpenCLIP ViT-bigG/14, exact GELU) are
read at their penultimate layer with no final LayerNorm (`penultimate`);
bigG's end-of-text state after `ln_final`, the largest id of each row,
goes through `text_projection` to the pooled embedding (`projection_dim`):
`encode` gives both.

Token ids must lie in [0, vocab_size): out-of-range ids raise a ValueError
(JAX's gather would clamp them silently, and a CUDA gather would fault).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
        self.transformer = Transformer(config.width, config.layers, config.heads,
                                       quick=config.quick_gelu)
        self.ln_final = LayerNorm(config.width, eps=1e-5)
        if config.projection_dim:
            self.text_projection = nn.Parameter(torch.empty(config.width, config.projection_dim))

    def forward(self, tokens) -> torch.Tensor:
        """tokens (N, S) integer ids -> hidden states (N, S, width) fp32."""
        return self.encode(tokens)[0]

    def encode(self, tokens) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """tokens (N, S) integer ids -> (hidden states (N, S, width) fp32,
        the pooled projection (N, projection_dim) fp32 or None). The
        states are the final LayerNorm's, or with `penultimate` the last
        layer's input; a tower without a projection skips its last layer
        there."""
        cfg = self.config
        weight = self.token_embedding.weight
        tokens = checked_token_ids(tokens, cfg.vocab_size, weight.device)
        seq = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:seq].to(weight.dtype)
        mask = causal_mask(seq, device=weight.device)
        if not cfg.penultimate:
            return self.ln_final(self.transformer(x, mask)), None
        blocks = self.transformer.resblocks
        for block in blocks[:-1]:
            x = block(x, mask)
        states = x.float()
        if not cfg.projection_dim:
            return states, None
        pooled = self.ln_final(blocks[-1](x, mask))
        pooled = pooled[torch.arange(pooled.shape[0], device=pooled.device), tokens.argmax(dim=-1)]
        proj = self.text_projection
        return states, (pooled.to(proj.dtype) @ proj).float()
