"""The general traffic generator.  A mix (`traffic/<name>.json`) is data:

    op            "write" (archives back to back through the Writer),
                  "scan" (full sequential passes, each on a fresh Reader)
                  or "pread" (random pread_full calls by one client on one
                  open Reader, at uniform offsets)
    write_bytes   size of each Writer.write call ("write")
    read_bytes    size of each read ("scan", "pread")

The input is the configuration's `input_bytes` of mixed_corpus.  The same
seed gives the same bytes and the same offsets.  mixed_corpus is a copy
of the port's libzseek_tpu_torch/testing/corpus.py, so that a later
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np


def mixed_corpus(rng: np.random.Generator, n: int) -> np.ndarray:
    """Quarters of text-like bytes (a skewed 18-letter alphabet), a
    period-337 repeat, zeros and noise."""
    parts = []
    alpha = np.frombuffer(b"abcdefgh THEramble", dtype=np.uint8)
    probs = np.arange(len(alpha), 0, -1, dtype=np.float64)
    probs /= probs.sum()
    parts.append(rng.choice(alpha, size=n // 4, p=probs).astype(np.uint8))
    block = rng.integers(0, 256, size=337, dtype=np.uint8)
    parts.append(np.tile(block, n // 4 // 337 + 1)[: n // 4])
    parts.append(np.zeros(n // 4, dtype=np.uint8))
    parts.append(rng.integers(0, 256, size=n - 3 * (n // 4), dtype=np.uint8))
    return np.concatenate(parts)


def corpus(config: dict, seed: int) -> bytes:
    n = int(config["input_bytes"])
    return mixed_corpus(np.random.default_rng(seed), n).tobytes()


def offsets(mix: dict, size: int, seed: int, count: int,
            stream: int = 0) -> np.ndarray:
    """`count` uniform read offsets into an input of `size` bytes, each
    leaving room for `read_bytes`.  `stream` tells the warm-up's offsets
    apart from the window's."""
    rng = np.random.default_rng([seed, 1 + stream])
    return rng.integers(0, size - int(mix["read_bytes"]) + 1, count)
