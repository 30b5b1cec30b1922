"""K5's chain walk on the card (csrc/lz4_emit.cu: one thread a chain of
rows, the tagged table in device memory) against its plain version on
rows that drive each of its steps: twelve linked 64 KiB rows of text,
short-period repeats (every word repeats a few bytes back) and long runs
of one byte, a fence in the middle of the batch, a short last row and
the row-0 seed; and the 128-row batch shape of the LZ4 write path.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are bytes and lengths and must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import LZ4Codec
from libzseek_tpu_torch.ops import lz4_emit as LE
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from test_torch_cuda_inputs import cuda_device, same

pytestmark = pytest.mark.cuda
BLOCK = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _both(D, lens, mr, cuda, level=0):
    cap = LE.out_cap(D.shape[1])
    kw = LZ4Codec._level_params(level)
    args = [torch.from_numpy(a) for a in (D, lens, mr)]
    got = LE.lz4_emit(*[a.to(cuda) for a in args], cap, **kw)
    same(got, LE.lz4_emit(*args, cap, **kw))


def test_walk_steps_match_plain(cuda):
    """Twelve linked 64 KiB rows of text, short-period repeats and runs of
    one byte, a fence in the middle and a short last row, at every level
    arm; then the same rows seeded (row 0 the previous block, min_ref
    0)."""
    rng = np.random.default_rng(83)
    parts = [text_corpus(rng, 4 * BLOCK),
             np.tile(rng.integers(0, 256, 12, np.uint8), 4 * BLOCK // 12 + 1)
             [: 4 * BLOCK],
             np.repeat(rng.integers(0, 4, 4 * BLOCK // 900 + 1,
                                    np.uint8), 900)[: 4 * BLOCK]]
    x = np.concatenate(parts)
    B = 12
    D = np.zeros((B + 1, BLOCK), np.uint8)
    D[1:] = x.reshape(B, BLOCK)
    lens = np.full(B, 2 * BLOCK, np.int32)
    lens[-1] = BLOCK + 4097
    mr = (np.arange(B, dtype=np.int32)) * BLOCK
    mr[0], mr[6] = BLOCK, 7 * BLOCK
    for level in (-1, 0, 3, 9):
        _both(D, lens, mr, cuda, level)
    D[0] = x[-BLOCK:]
    mr[0] = 0
    _both(D, lens, mr, cuda, 0)


def test_path_batch_matches_plain(cuda):
    """The LZ4 write path's batch: 128 rows, 8 frames of 16 blocks of the
    mixed corpus, two frames from each quarter."""
    data = mixed_corpus(np.random.default_rng(11), 64 << 20)
    B = 128
    D = np.zeros((B + 1, BLOCK), np.uint8)
    for f in range(8):
        for j in range(16):
            off = f * (8 << 20) + j * BLOCK
            D[1 + 16 * f + j] = data[off: off + BLOCK]
    i = np.arange(B)
    mr = np.where(i % 16 == 0, (i + 1) * BLOCK, i * BLOCK).astype(np.int32)
    _both(D, np.full(B, 2 * BLOCK, np.int32), mr, cuda)
