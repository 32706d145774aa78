"""Deterministic hash encoder for hermetic tests and air-gapped runs (port
of rust_local_rag_tpu/models/fake_encoder.py).

No weights and no network: embedding(text) is the L2-normalised sum of one
seeded pseudo-random vector per lower-cased word plus a quarter of one per
word bigram, so similar texts get similar vectors. It is numpy end to end
(the same BLAKE2b seeds and numpy generator as the JAX package's), so the
two packages give bit-identical vectors.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+")


def _token_vector(token: str, dim: int) -> np.ndarray:
    """Deterministic pseudo-random vector for a token."""
    seed = int.from_bytes(hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(), "little")
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


class HashEncoder:
    """Vocabulary-free deterministic text encoder."""

    def __init__(self, dim: int = 768, model_name: str = "fake-hash-encoder"):
        self.dim = dim
        self._model_name = model_name
        self._cache: dict[str, np.ndarray] = {}
        self._cache_cap = 50_000

    @property
    def model_name(self) -> str:
        return self._model_name

    def _tok_vec(self, token: str) -> np.ndarray:
        v = self._cache.get(token)
        if v is None:
            v = _token_vector(token, self.dim)
            if len(self._cache) < self._cache_cap:
                self._cache[token] = v
        return v

    def encode_one(self, text: str) -> np.ndarray:
        words = _WORD_RE.findall(text.lower())
        acc = np.zeros(self.dim, dtype=np.float32)
        for w in words:
            acc += self._tok_vec(w)
        for a, b in zip(words, words[1:]):
            acc += 0.25 * self._tok_vec(a + "##" + b)
        norm = float(np.linalg.norm(acc))
        if norm > 1e-10:
            acc /= norm
        return acc

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.encode_one(t) for t in texts])

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
