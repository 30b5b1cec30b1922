"""Reproducible test/bench corpora covering the regimes that matter for an
LZ codec: compressible text-like data, short-period repeats, long zero runs,
and incompressible noise.  Mirrors the role of the reference benchmark's
user-supplied input file (test/benchmark.c:161-192 of the reference
library) with a deterministic generator instead.

Copy of libzseek_tpu/testing/corpus.py: the same generators, so the same
seed gives the same bytes in both packages."""

from __future__ import annotations

import numpy as np


def mixed_corpus(rng: np.random.Generator, n: int) -> np.ndarray:
    parts = []
    # text-like: small alphabet with skewed distribution
    alpha = np.frombuffer(b"abcdefgh THEramble", dtype=np.uint8)
    probs = np.arange(len(alpha), 0, -1, dtype=np.float64)
    probs /= probs.sum()
    parts.append(rng.choice(alpha, size=n // 4, p=probs).astype(np.uint8))
    # repeated block (long matches, period 337)
    block = rng.integers(0, 256, size=337, dtype=np.uint8)
    parts.append(np.tile(block, n // 4 // 337 + 1)[: n // 4])
    # zero run (RLE regime)
    parts.append(np.zeros(n // 4, dtype=np.uint8))
    # incompressible noise
    parts.append(rng.integers(0, 256, size=n - 3 * (n // 4), dtype=np.uint8))
    return np.concatenate(parts)


def text_corpus(rng: np.random.Generator, n: int) -> np.ndarray:
    """Markov-ish text: the hardest realistic regime for segment-granular
    match selection (dense short matches)."""
    alpha = np.frombuffer(
        b"etaoin shrdlucmfwypvbgkjqxz,.\n", dtype=np.uint8)
    probs = np.arange(len(alpha), 0, -1, dtype=np.float64) ** 1.5
    probs /= probs.sum()
    return rng.choice(alpha, size=n, p=probs).astype(np.uint8)
