"""K1's warp walk on the card against its plain version, on rows that
drive each of its decisions: a lazy step that takes the later match, a
repcode hit that wins over the table, short4 in a strict row, a row that
reaches CAP sequences, a chain fenced inside by min_abs, and frames whose
last row is shorter than N (down to one too short to probe).

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are integer words and must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.ops.parse_linked import CAP, parse_linked
from libzseek_tpu_torch.ops.zstd_encode import (block_entropy_h16,
                                                level_search_params)
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import arms_rows, cuda_device, same

pytestmark = pytest.mark.cuda
N = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _both(x2, lens, min_abs, cuda, **prm):
    args = [torch.from_numpy(a) for a in (x2, lens, min_abs)]
    args.append(block_entropy_h16(args[0][1:], args[1])[0])
    got = parse_linked(*(a.to(cuda) for a in args), **prm)
    ref = parse_linked(*args, **prm)
    same(got, ref)
    return [t.numpy() for t in ref]


def _edge_rows():
    """Seven 64 KiB rows: 5-byte words drawn from 64 random ones (a
    sequence every 5-6 bytes: past CAP at every level); text; text
    fenced 30,000 bytes into its previous block; the frame's last row,
    20,000 bytes; a new frame of the mixed corpus's regimes and its last
    row of 100 bytes; a frame of one 10-byte row, too short to probe."""
    rng = np.random.default_rng(83)
    x2 = np.zeros((8, N), np.uint8)
    words = rng.integers(0, 256, (64, 5), np.uint8)
    x2[1] = words[rng.integers(0, 64, N // 5 + 1)].reshape(-1)[:N]
    x2[2:6] = mixed_corpus(np.random.default_rng(89), 4 * N) \
        .reshape(4, N)[[0, 0, 0, 1]]
    x2[3, : N // 2] = x2[2, N // 4: 3 * N // 4]     # half below the fence
    x2[6:8] = mixed_corpus(np.random.default_rng(97), 2 * N).reshape(2, N)
    lens = np.array([N, N, N, 20000, N, 100, 10], np.int32)
    i = np.arange(7)
    min_abs = (i * N).astype(np.int32)
    min_abs[[0, 4, 6]] = (i[[0, 4, 6]] + 1) * N       # frame starts
    min_abs[2] = 2 * N + 30000                        # a fence inside
    return x2, lens, min_abs


def test_lazy_rep_short4_rows_match_plain(cuda):
    """The crafted rows of each level >= 4 arm, at levels 4, 9 and 16:
    the lazy steps' later match, the rep probe's win over the table and
    short4 in the strict row are what the plain walk keeps."""
    x2, lens, min_abs = arms_rows()
    for level in (4, 9, 16):
        nn = _both(x2, lens, min_abs, cuda, **level_search_params(level))[3]
        assert (nn > 0).all()


def test_cap_fence_and_short_rows_match_plain(cuda):
    """Levels 3, 4, 9 and 16 on the edge rows: the CAP row stops at CAP
    sequences, the short rows parse what they hold."""
    x2, lens, min_abs = _edge_rows()
    for level in (3, 4, 9, 16):
        nn, cover = _both(x2, lens, min_abs, cuda,
                          **level_search_params(level))[3:5]
        assert nn[0] == CAP
        assert nn[6] == 0 and cover[6] == 0
