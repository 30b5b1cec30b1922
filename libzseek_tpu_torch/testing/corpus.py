"""Reproducible test/bench corpora covering the regimes that matter for an
LZ codec: compressible text-like data, short-period repeats, long zero runs,
and incompressible noise.  Mirrors the role of the reference benchmark's
user-supplied input file (test/benchmark.c:161-192 of the reference
library) with a deterministic generator instead.

Copy of libzseek_tpu/testing/corpus.py: the same generators, so the same
seed gives the same bytes in both packages; log_corpus is the port's
own."""

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


LOG_WORDS = (b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot",
             b"golf", b"hotel")


def log_corpus(rng: np.random.Generator, n: int) -> np.ndarray:
    """Log-like lines b"%02x word=word;\\n" (a random byte in hex, two words
    of an 8-word vocabulary): dense short matches that survive the hash
    parser's gate, more than 4096 sequences per 128 KiB block."""
    k = n // 10 + 1
    hx, a, b = (rng.integers(0, m, k) for m in (256, 8, 8))
    lines = b"".join(b"%02x %s=%s;\n" % (h, LOG_WORDS[i], LOG_WORDS[j])
                     for h, i, j in zip(hx.tolist(), a.tolist(), b.tolist()))
    return np.frombuffer(lines[:n], np.uint8).copy()
