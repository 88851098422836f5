"""Sentence embedding for the TAR reward's cosine matching (MiniLM when its
weights are local, else the loud HashingEmbedder fallback).

A copy of ``video_r2_tpu/rewards/embedding.py`` (its package ``__init__``
imports jax); tests/test_torch_host.py holds every function and class
here equal to the original's source.
"""

from __future__ import annotations

import hashlib

import numpy as np


class HashingEmbedder:
    """Char-ngram hashing -> L2-normalized vectors. Deterministic, offline."""

    def __init__(self, dim: int = 512, ngram: tuple[int, int] = (2, 4)):
        self.dim = dim
        self.ngram = ngram

    def encode(self, sentences: list[str]) -> np.ndarray:
        out = np.zeros((len(sentences), self.dim), np.float32)
        for i, s in enumerate(sentences):
            s = s.lower().strip()
            for n in range(self.ngram[0], self.ngram[1] + 1):
                for j in range(max(0, len(s) - n + 1)):
                    g = s[j: j + n]
                    hcode = int.from_bytes(
                        hashlib.md5(g.encode()).digest()[:4], "little")
                    out[i, hcode % self.dim] += 1.0
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out


def load_embedder(model_name: str = "sentence-transformers/all-MiniLM-L6-v2"):
    """MiniLM if its weights are locally available, else HashingEmbedder.

    The fallback is LOUD (VERDICT r1 weak #9): TAR consistency scores
    computed with the hashing embedder are NOT comparable to the reference's
    MiniLM numbers, so substituting silently would corrupt cross-run
    comparisons. Detect which one ran via `is_fallback_embedder`."""
    try:
        from sentence_transformers import SentenceTransformer

        return SentenceTransformer(model_name, local_files_only=True)
    except Exception:
        import logging

        logging.getLogger(__name__).warning(
            "MiniLM (%s) unavailable locally — TAR similarity falls back to "
            "the char-ngram HashingEmbedder. Scores are deterministic but NOT "
            "comparable to MiniLM-based runs; metrics are tagged "
            "embedder=hashing-fallback.", model_name)
        return HashingEmbedder()


def is_fallback_embedder(embedder) -> bool:
    return isinstance(embedder, HashingEmbedder)


def embedder_tag(embedder) -> str:
    """Provenance tag recorded next to TAR metrics."""
    return "hashing-fallback" if is_fallback_embedder(embedder) else "minilm"


def cos_sim(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))
