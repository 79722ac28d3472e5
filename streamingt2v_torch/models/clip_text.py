"""CLIP text tower and BPE tokenizer for the I2VGen-XL enhancement prompts
(counterpart of ``streamingt2v_tpu/models/clip_text.py``).

The OpenCLIP ViT-H text tower in HF layout: token + position embeddings,
pre-LN causal transformer layers (width 1024, 16 heads, GELU), final layer
norm; returns the last hidden state.  The tokenizer is CLIP's byte-level BPE
reading the vocab.json / merges.txt that ship with the checkpoint, or a
byte-level stand-in (``synthetic``) when those files are absent.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import html
import json
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from streamingt2v_torch.models.layers import Dense, Embed, _param, norm_pair, norm_params
from streamingt2v_torch.ops import layer_norm
from streamingt2v_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    layers: int = 24
    heads: int = 16
    max_length: int = 77
    mlp_ratio: float = 4.0
    hidden_act: str = "gelu"  # the laion ViT-H text tower uses plain GELU

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=64, width=32, layers=2, heads=2, max_length=8)


class CLIPTextLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        c = cfg.width
        self.cfg = cfg
        norm_params(self, "ln1", c, **fk)
        self.q_proj = Dense(c, c, **fk)
        self.k_proj = Dense(c, c, **fk)
        self.v_proj = Dense(c, c, **fk)
        self.out_proj = Dense(c, c, **fk)
        norm_params(self, "ln2", c, **fk)
        self.fc1 = Dense(c, int(c * cfg.mlp_ratio), **fk)
        self.fc2 = Dense(int(c * cfg.mlp_ratio), c, **fk)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        n, length, c = x.shape
        heads = self.cfg.heads
        h = layer_norm(x, *norm_pair(self, "ln1"))
        q, k, v = (proj(h).reshape(n, length, heads, c // heads).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        o = dot_product_attention(q, k, v, bias=causal_bias)
        x = x + self.out_proj(o.transpose(1, 2).reshape(n, length, c))
        h = self.fc1(layer_norm(x, *norm_pair(self, "ln2")))
        if self.cfg.hidden_act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h.float()).to(h.dtype)
        return x + self.fc2(h)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, cfg.width, **fk)
        self.position_embedding = _param((cfg.max_length, cfg.width), device, dtype)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", CLIPTextLayer(cfg, **fk))
        norm_params(self, "final_ln", cfg.width, **fk)

    @torch.no_grad()
    def init_extra_(self, generator: torch.Generator) -> None:
        """normal(0.01) position embedding."""
        p = self.position_embedding
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.01)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids (B, L) int -> last hidden state (B, L, width)."""
        length = token_ids.shape[1]
        x = self.token_embedding(token_ids) + self.position_embedding[:length]
        causal = torch.triu(torch.full((length, length), -1e9, device=x.device), diagonal=1)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        return layer_norm(x, *norm_pair(self, "final_ln"))


# --------------------------------------------------------------------------
# CLIP BPE tokenizer (file-based, no network)
# --------------------------------------------------------------------------

@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """Byte-pair encoding tokenizer with CLIP's text cleaning and the
    <|startoftext|>/<|endoftext|> framing, padded to max_length."""

    PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]"
        r"|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.sot = vocab.get("<|startoftext|>")
        self.eot = vocab.get("<|endoftext|>")
        self.cache: Dict[str, str] = {}

    @classmethod
    def synthetic(cls, max_length: int = 77) -> "CLIPTokenizer":
        """Byte-level tokenizer with an empty merge table: a stand-in for the
        published 49k-BPE vocab when its files are unavailable.  Every byte
        maps to a stable id below 514; framing, padding and cleaning behave
        as with the real vocab."""
        chars = list(_bytes_to_unicode().values())
        vocab = {c: i for i, c in enumerate(chars)}
        vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
        vocab["<|startoftext|>"] = 2 * len(chars)
        vocab["<|endoftext|>"] = 2 * len(chars) + 1
        return cls(vocab, [], max_length)

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path) as f:
            vocab = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#") and len(line.split()) == 2]
        return cls(vocab, merges, max_length)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for token in re.findall(self.PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        """-> (B, max_length) int32: sot + ids + eot, eot-padded."""
        out = np.full((len(texts), self.max_length), self.eot, np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text)[: self.max_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out
