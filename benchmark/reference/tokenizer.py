"""CLIP's byte-pair tokenizer over a frozen copy of OpenAI's merges file
(`bpe_simple_vocab_16e6.txt.gz`, beside this file).

`tokenize` gives (N, context_length) int64 ids: <|startoftext|>, the
prompt's tokens, <|endoftext|>, then `pad_id`; an over-long prompt is cut
with <|endoftext|> kept last. The word pattern is the ASCII form of CLIP's
(letters, single digits, other non-space runs): the benchmark's prompts are
ASCII, on which it splits as the unicode form does.
"""

from __future__ import annotations

import gzip
import os
import re
from typing import Dict, List, Sequence

import numpy as np

MERGES = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")
_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


def _byte_symbols() -> Dict[int, str]:
    """GPT-2's reversible map from bytes to printable characters."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
                 + list(range(0xAE, 0x100)))
    symbols, extra = {}, 0
    for b in range(256):
        if b in printable:
            symbols[b] = chr(b)
        else:
            symbols[b] = chr(256 + extra)
            extra += 1
    return symbols


class BPETokenizer:
    def __init__(self, merges_path: str = MERGES):
        with gzip.open(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line]
        self.byte_symbols = _byte_symbols()
        # the byte symbols in byte order of GPT-2's table: printable ones first
        ordered = sorted(self.byte_symbols.items(),
                         key=lambda kv: (kv[1] != chr(kv[0]), ord(kv[1])))
        base = [s for _, s in ordered]
        vocab = base + [s + "</w>" for s in base] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {token: i for i, token in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot_token = self.ids["<|startoftext|>"]
        self.eot_token = self.ids["<|endoftext|>"]

    def _bpe(self, token: str) -> List[str]:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids = []
        for token in _PATTERN.findall(text):
            token = "".join(self.byte_symbols[b] for b in token.encode("utf-8"))
            ids.extend(self.ids[t] for t in self._bpe(token) if t in self.ids)
        return ids


def tokenize(tokenizer, texts: Sequence[str], context_length: int, pad_id: int) -> np.ndarray:
    out = np.full((len(texts), context_length), pad_id, dtype=np.int64)
    for row, text in enumerate(texts):
        ids = [tokenizer.sot_token] + tokenizer.encode(text) + [tokenizer.eot_token]
        if len(ids) > context_length:
            ids = ids[:context_length - 1] + [tokenizer.eot_token]
        out[row, :len(ids)] = ids
    return out
