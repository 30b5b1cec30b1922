"""K7's CUDA kernel and the hash-parser codec on the card against their
plain versions.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are sequences, counts and frame bytes and must be equal
(tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.ops import hash_parse as HP
from libzseek_tpu_torch.testing.corpus import (log_corpus, mixed_corpus,
                                               text_corpus)
from test_torch_cuda_inputs import cuda_device, same

pytestmark = pytest.mark.cuda

N = 1 << 17


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _k7_cases():
    """(X, lengths): four 16 KiB rows (text, mixed, zeros, repeats) with a
    short one and an empty one; 64 rows of 128 KiB: 8 log-like, 8 text
    and 48 from every regime of a mixed corpus, some of them short."""
    rng = np.random.default_rng(83)
    n = 16384
    small = np.stack([text_corpus(rng, n), mixed_corpus(rng, n),
                      np.zeros(n, np.uint8),
                      np.tile(rng.integers(0, 256, 337, np.uint8),
                              n // 337 + 1)[:n], text_corpus(rng, n),
                      text_corpus(rng, n)])
    m = mixed_corpus(rng, 48 * N).reshape(48, N)
    big = np.concatenate([log_corpus(rng, 8 * N).reshape(8, N),
                          text_corpus(rng, 8 * N).reshape(8, N), m])
    lens = np.full(64, N, np.int32)
    lens[[5, 20, 63]] = (N - 777, 4000, 13)
    return [(small, np.array([n, n, n, n, 9999, 0], np.int32)), (big, lens)]


def test_k7_kernel_matches_plain(cuda):
    for X, lens in _k7_cases():
        args = [torch.from_numpy(X), torch.from_numpy(lens)]
        got = HP.hash_parse(*[a.to(cuda) for a in args])
        ref = HP.hash_parse(*args)
        same(got, ref)


def test_hash_codec_frames_match_plain(cuda):
    """A mixed frame (the K2 arm) and a log-like frame (the XLA arm), on
    the card and with device="cpu"."""
    rng = np.random.default_rng(89)
    for raw in (mixed_corpus(rng, 4 * N).tobytes(),
                log_corpus(rng, 2 * N + 999).tobytes()):
        got = ZstdCodec(device="cuda", parser="hash").compress_frames([raw])
        ref = ZstdCodec(device="cpu", parser="hash").compress_frames([raw])
        assert got == ref
