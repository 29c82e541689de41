"""Toy hash tokenizer + synthetic document generator (numpy), the port's
copy of the reference package's ``data/tokenizer.py``.

Documents follow a Zipfian unigram distribution with short-range bigram
structure, so a small model has actual signal to learn.
"""
from __future__ import annotations

import numpy as np

BOS = 1
EOS = 2
SPECIAL = 4  # 0=pad, 1=bos, 2=eos, 3=unk


class HashTokenizer:
    """Deterministic string→id hashing; ids land in [SPECIAL, vocab)."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str) -> list[int]:
        out = [BOS]
        for w in text.split():
            h = 2166136261
            for c in w.encode():
                h = ((h ^ c) * 16777619) & 0xFFFFFFFF
            out.append(SPECIAL + h % (self.vocab - SPECIAL))
        out.append(EOS)
        return out

    def zipf_probs(self, alpha: float) -> np.ndarray:
        n = self.vocab - SPECIAL
        p = 1.0 / np.arange(1, n + 1) ** alpha
        return p / p.sum()


def synthetic_document(
    rng: np.random.Generator,
    tok: HashTokenizer,
    alpha: float = 1.2,
    mean_len: int = 128,
) -> list[int]:
    """Zipf unigrams + deterministic successor structure (each token t is
    followed by (t*31+7) % vocab with prob 0.35 — learnable bigrams)."""
    n = max(int(rng.exponential(mean_len)), 8)
    probs = tok.zipf_probs(alpha)
    base = rng.choice(len(probs), size=n, p=probs) + SPECIAL
    doc = [BOS]
    prev = int(base[0])
    for i in range(n):
        if rng.random() < 0.35 and i > 0:
            cur = SPECIAL + (prev * 31 + 7) % (tok.vocab - SPECIAL)
        else:
            cur = int(base[i])
        doc.append(cur)
        prev = cur
    doc.append(EOS)
    return doc
