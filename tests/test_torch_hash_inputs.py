"""Shared inputs of the hash-parser path's CPU parity tests
(tests/test_torch_hash_*.py, tests/test_torch_xla_*.py).  It holds no
tests.

Every input is made with numpy from a fixed seed.  The reference's K7
runs in interpret mode (as tests/test_pallas_parse.py runs it); the
log-like generator is the port's testing.corpus.log_corpus, whose
128 KiB blocks keep more than 4096 sequences after the gate."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import pallas_match as pm
from libzseek_tpu.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch.convert import to_numpy
from libzseek_tpu_torch.ops.hash_parse import hash_parse
from libzseek_tpu_torch.testing.corpus import log_corpus

N = 1 << 17         # the codec's block
N_SMALL = 16384     # tests/test_pallas_parse.py's rows
SHORT = N - 4321    # a frame's short last block


def log_like(seed: int, n: int) -> bytes:
    """Seeded log-like lines b"%02x word=word;\\n"."""
    return log_corpus(np.random.default_rng(seed), n).tobytes()


@functools.lru_cache(maxsize=None)
def small_rows():
    """tests/test_pallas_parse.py's four 16 KiB rows (text, mixed, zeros,
    period-337 repeats), from seed 17: (X, lengths)."""
    rng = np.random.default_rng(17)
    rows = [text_corpus(rng, N_SMALL), mixed_corpus(rng, N_SMALL),
            np.zeros(N_SMALL, np.uint8),
            np.tile(rng.integers(0, 256, 337, np.uint8),
                    N_SMALL // 337 + 1)[:N_SMALL]]
    return np.stack(rows), np.full(4, N_SMALL, np.int32)


@functools.lru_cache(maxsize=None)
def block_rows():
    """Three 128 KiB rows, seed 19: log-like, mixed, and text as a short
    last block (zeros past its length): (X, lengths)."""
    rng = np.random.default_rng(19)
    X = np.stack([log_corpus(rng, N), mixed_corpus(rng, N),
                  text_corpus(rng, N)])
    X[2, SHORT:] = 0
    return X, np.array([N, N, SHORT], np.int32)


def k7_reference(X, lens):
    """The Pallas K7 in interpret mode: numpy (ll, ml, offv, n_seq,
    cover_end)."""
    out = pm.hash_parse_blocks_smem(jnp.asarray(X), jnp.asarray(lens),
                                    interpret=True)
    return [np.asarray(a) for a in out]


@functools.lru_cache(maxsize=None)
def k7_plain(which: str):
    """The port's plain K7 on small_rows() or block_rows(): numpy arrays."""
    X, lens = small_rows() if which == "small" else block_rows()
    return [a.numpy() for a in hash_parse(torch.from_numpy(X),
                                          torch.from_numpy(lens))]


def interpret_k7(monkeypatch):
    """Run the JAX package's K7 in interpret mode inside a test (its
    ZstdCodec(parser="hash") calls it without the flag)."""
    monkeypatch.setattr(pm, "hash_parse_blocks_smem",
                        functools.partial(pm.hash_parse_blocks_smem,
                                          interpret=True))


@jax.jit
def xla_gate_entropy(hist):
    """The reference's gate entropy, the expression of
    libzseek_tpu/ops/zstd_encode.py:_fast_post_nolit (:489-494)."""
    pr = hist.astype(jnp.float32) / jnp.maximum(
        jnp.sum(hist, axis=1, keepdims=True).astype(jnp.float32), 1.0)
    H = -jnp.sum(jnp.where(pr > 0, pr * jnp.log2(jnp.maximum(pr, 1e-9)),
                           0.0), axis=1)
    return jnp.clip(H, 1.0, 8.0)


def skewed_hists(seed: int, n: int) -> np.ndarray:
    """n byte histograms (n, 256) int32 of 1-256 used symbols with
    Zipf-like counts summing to at most 128 Ki."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 256), np.int64)
    for i in range(n):
        k = int(rng.integers(1, 257))
        counts = rng.zipf(1.05 + 2 * rng.random(), k).astype(np.int64)
        counts = np.minimum(counts, N)
        out[i, rng.choice(256, k, replace=False)] = counts
        total = out[i].sum()
        if total > N:
            out[i] = np.maximum(out[i] * N // total, out[i] > 0)
    return out.astype(np.int32)


def eq(port, ref, msg=""):
    ref = np.asarray(ref)
    got = to_numpy(port, np.uint32 if ref.dtype == np.uint32 else None)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=msg)


def with_repeat(raw: bytes) -> bytes:
    """raw's first 128 KiB block again after raw: a whole-block match
    beyond the parse's window, which the long-distance pre-pass turns
    into one sequence (its row's literal plane comes from the host)."""
    return raw + raw[:N]


class Spy:
    """Counts the calls of one method of the port's ZstdCodec."""

    def __init__(self, monkeypatch, name):
        from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
        self.calls = 0
        orig = getattr(ZstdCodec, name)

        def spy(codec, *a, **kw):
            self.calls += 1
            return orig(codec, *a, **kw)
        monkeypatch.setattr(ZstdCodec, name, spy)
