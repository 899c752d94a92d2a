"""BERT-style x-transformer text encoder and WordPiece tokenizer for LDM
txt2img conditioning (counterpart of
perceptor_tpu/models/latent_diffusion/bert.py).

Token embedding + learned absolute positions, `depth` pre-LN blocks of
[attention (no-bias q/k/v, 8 heads of 64), feed-forward (exact GELU, x4)],
a final LayerNorm; the embeddings are returned. Module names are the
x-transformer `TransformerWrapper`'s (`token_emb`, `pos_emb.emb`,
`attn_layers.layers.{2i}.{0,1}` for a block's norm and attention,
`.{2i+1}.1.net.{0.0,2}` for its feed-forward, `norm`), so a CompVis
`cond_stage_model.transformer.*` state_dict loads as it is and the JAX
package's `convert_bert` reads this module's. 77 tokens take the plain
dot-product route.

Tokenization is host-side WordPiece against a local bert-base-uncased
vocab.txt, found at `_VOCAB_PATHS` or passed as `vocab=`; no file ships in
the tree.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.models.clip.model import checked_token_ids
from perceptor_tpu_torch.ops.attention import dot_product_attention
from perceptor_tpu_torch.ops.layers import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class BERTConfig:
    vocab_size: int = 30522
    width: int = 1280
    depth: int = 32
    heads: int = 8
    dim_head: int = 64
    max_seq_len: int = 77


TINY_BERT = BERTConfig(vocab_size=64, width=32, depth=2, heads=2, dim_head=16,
                       max_seq_len=16)


class XTransformerAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x):
        b, s, _ = x.shape

        def split(t):
            return t.view(b, s, self.heads, self.dim_head).transpose(1, 2)

        out = dot_product_attention(split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x)))
        return self.to_out(out.transpose(1, 2).reshape(b, s, self.heads * self.dim_head))


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList(
            [nn.ModuleList([Linear(dim, dim * 4)]), nn.Identity(), Linear(dim * 4, dim)]
        )

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0][0](x)))


class _AbsolutePositions(nn.Module):
    def __init__(self, max_seq_len: int, width: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, width)


class _AttentionLayers(nn.Module):
    def __init__(self, cfg: BERTConfig):
        super().__init__()
        layers = []
        for _ in range(cfg.depth):
            layers.append(nn.ModuleList([
                LayerNorm(cfg.width, eps=1e-5),
                XTransformerAttention(cfg.width, cfg.heads, cfg.dim_head),
            ]))
            layers.append(nn.ModuleList([LayerNorm(cfg.width, eps=1e-5), FeedForward(cfg.width)]))
        self.layers = nn.ModuleList(layers)


class BERTEncoder(nn.Module):
    def __init__(self, config: BERTConfig):
        super().__init__()
        self.config = config
        self.token_emb = nn.Embedding(config.vocab_size, config.width)
        self.pos_emb = _AbsolutePositions(config.max_seq_len, config.width)
        self.attn_layers = _AttentionLayers(config)
        self.norm = LayerNorm(config.width, eps=1e-5)

    def forward(self, tokens) -> torch.Tensor:
        """tokens (N, S) integer ids in [0, vocab_size) -> (N, S, width)
        fp32 embeddings."""
        weight = self.token_emb.weight
        tokens = checked_token_ids(tokens, self.config.vocab_size, weight.device)
        x = self.token_emb(tokens) + self.pos_emb.emb.weight[: tokens.shape[1]].to(weight.dtype)
        for norm, block in self.attn_layers.layers:
            x = x + block(norm(x))
        return self.norm(x)


# -- WordPiece tokenizer (bert-base-uncased semantics) ------------------------

_VOCAB_PATHS = (
    "models/bert-base-uncased-vocab.txt",
    os.path.expanduser("~/.cache/perceptor_tpu/bert-base-uncased-vocab.txt"),
)


class BERTTokenizer:
    def __init__(self, vocab: Optional[Sequence[str]] = None, max_length: int = 77):
        if vocab is None:
            for path in _VOCAB_PATHS:
                if os.path.exists(path):
                    with open(path, encoding="utf-8") as f:
                        vocab = [line.rstrip("\n") for line in f]
                    break
            else:
                raise FileNotFoundError(
                    "BERT vocab not found; place bert-base-uncased-vocab.txt in "
                    f"{_VOCAB_PATHS} or pass vocab=."
                )
        self.vocab = {token: i for i, token in enumerate(vocab)}
        self.max_length = max_length
        self.cls = self.vocab.get("[CLS]", 0)
        self.sep = self.vocab.get("[SEP]", 0)
        self.pad = self.vocab.get("[PAD]", 0)
        self.unk = self.vocab.get("[UNK]", 0)

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        tokens, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            tokens.append(piece)
            start = end
        return tokens

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """texts -> (N, max_length) int32 ids: [CLS] word pieces [SEP], cut
        to max_length, padded with [PAD]."""
        rows = []
        for text in texts:
            words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
            ids = [self.cls]
            for word in words:
                ids.extend(self._wordpiece(word))
            ids = ids[: self.max_length - 1] + [self.sep]
            ids = ids + [self.pad] * (self.max_length - len(ids))
            rows.append(ids)
        return np.asarray(rows, dtype=np.int32)
