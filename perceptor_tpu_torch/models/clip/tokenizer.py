"""CLIP BPE tokenizer (counterpart of perceptor_tpu/models/clip/tokenizer.py).

The byte-pair tokenizer of every CLIP checkpoint, in pure Python. It loads
the standard `bpe_simple_vocab_16e6.txt.gz` merges file, a copy of which
ships beside this module; a merges list can also be passed directly.
Tokenization runs on the host: `tokenize` returns an int64
(N, context_length) array, which the text encoder takes as is.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _regex_module():
    try:
        import regex

        return regex
    except ImportError:
        return None


def word_pattern(regex_mod=None):
    """The pre-tokenizer's word pattern: unicode letter and number classes
    with the `regex` module, else an ASCII pattern for std `re` (which
    lacks \\p). `regex_mod` None looks the module up; False forces the
    ASCII pattern."""
    regex_mod = _regex_module() if regex_mod is None else regex_mod
    if regex_mod:
        return regex_mod.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            regex_mod.IGNORECASE,
        )
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


class SimpleTokenizer:
    def __init__(
        self,
        bpe_path: Optional[str] = None,
        merges: Optional[List[Tuple[str, str]]] = None,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if merges is None:
            path = bpe_path or DEFAULT_BPE_PATH
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # the first line is a version header; merges occupy lines
            # 1..49152-256-2+1
            lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(line.split()) for line in lines if line]

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder = {token: i for i, token in enumerate(vocab)}
        self.decoder = {i: token for token, i in self.encoder.items()}
        self.bpe_ranks = {merge: i for i, merge in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = word_pattern()

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ") if t in self.encoder
            )
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(
    texts: Sequence[str],
    context_length: int = 77,
    tokenizer: Optional[SimpleTokenizer] = None,
) -> np.ndarray:
    """(N, context_length) int64 token array: <sot> tokens <eot>, 0-padded.

    Over-long prompts are truncated with EOT kept as the final token
    (open_clip's truncation)."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or SimpleTokenizer()
    sot, eot = tokenizer.sot_token, tokenizer.eot_token
    result = np.zeros((len(texts), context_length), dtype=np.int64)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = eot
        result[i, : len(tokens)] = tokens
    return result
