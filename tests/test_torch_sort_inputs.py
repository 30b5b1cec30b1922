"""Shared inputs of the sort parser's tests (tests/test_torch_match.py,
test_torch_greedy.py, test_torch_sort_*.py, test_torch_cuda_greedy.py).
It holds no tests.

Every input is made with numpy from a fixed seed.  Imports no jax: the
card test runs on the GPU machine with --noconftest."""

import functools

import numpy as np

from libzseek_tpu_torch.testing.corpus import (log_corpus, mixed_corpus,
                                               text_corpus)

N_ROW = 8192        # the match tests' rows
N = 1 << 17         # the codec's block
CTX = 2048          # the context prefix of the linked-row cases


@functools.lru_cache(maxsize=None)
def match_rows():
    """Six rows of 8 KiB, seed 61: mixed, text, log-like lines, zeros
    (ties in every window), period-37 repeats and noise; lengths full,
    short, and 11 (shorter than LZ4's 12-byte tail): (X, lengths)."""
    rng = np.random.default_rng(61)
    X = np.stack([mixed_corpus(rng, N_ROW), text_corpus(rng, N_ROW),
                  log_corpus(rng, N_ROW), np.zeros(N_ROW, np.uint8),
                  np.tile(rng.integers(0, 256, 37, np.uint8),
                          N_ROW // 37 + 1)[:N_ROW],
                  rng.integers(0, 256, N_ROW, np.uint8)])
    lens = np.array([N_ROW, N_ROW - 333, N_ROW, N_ROW, 5000, 11], np.int32)
    X[np.arange(N_ROW)[None, :] >= lens[:, None]] = 0
    return X, lens


def ctx_rows():
    """match_rows() as linked LZ4 rows: the first CTX bytes of each row
    are history, min_ref where each row's history starts (the last row
    has none, as a frame's first block): (X, lengths, min_ref)."""
    X, lens = match_rows()
    lens = np.maximum(lens, CTX).astype(np.int32)
    min_ref = np.array([0, 100, CTX - 7, 0, 1000, CTX], np.int32)
    return X, lens, min_ref


@functools.lru_cache(maxsize=None)
def block_rows():
    """Four 128 KiB rows, seed 67: mixed, text, log-like lines (more than
    4096 sequences after the gate) and a short text row: (X, lengths)."""
    rng = np.random.default_rng(67)
    X = np.stack([mixed_corpus(rng, N), text_corpus(rng, N),
                  log_corpus(rng, N), text_corpus(rng, N)])
    lens = np.array([N, N, N, N - 4321], np.int32)
    X[3, N - 4321:] = 0
    return X, lens


def greedy_synthetic(seed: int, B: int, nseg: int, seg_size: int,
                     c0: int = 0):
    """Random greedy_select inputs: per segment a start inside it, a
    length of 1-40 bytes, an offset, and a candidate flag with density
    0.05-0.9 per row; lengths include 0, 3, 11 and rows shorter than c0.
    Returns numpy (p, off, e, has, lengths)."""
    rng = np.random.default_rng(seed)
    base = np.arange(nseg, dtype=np.int32)[None, :] * seg_size
    p = (base + rng.integers(0, seg_size, (B, nseg))).astype(np.int32)
    e = (p + rng.integers(1, 41, (B, nseg))).astype(np.int32)
    off = rng.integers(1, 1 << 16, (B, nseg)).astype(np.int32)
    dens = rng.uniform(0.05, 0.9, (B, 1))
    has = rng.random((B, nseg)) < dens
    lengths = rng.integers(c0, nseg * seg_size + 1, B).astype(np.int32)
    lengths[: 4] = [0, 3, 11, max(0, c0 - 5)][: min(B, 4)]
    return p, off, e, has, lengths
