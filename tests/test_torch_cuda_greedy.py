"""The greedy_select kernel (csrc/greedy_select.cu) on the card against
its plain version (ops/match.py greedy_select_plain), at the sort
parser's shapes and on synthetic rows.

Marked `cuda`: it needs an NVIDIA GPU with sm_90a and nvcc, and skips
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are flags and positions and must be equal (tolerance: none)."""

import threading

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.ops import match as M
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import cuda_device, same
from test_torch_sort_inputs import greedy_synthetic

pytestmark = pytest.mark.cuda

N = 1 << 17
BLOCK = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _both(cuda, args, **kw):
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    n0 = M.launches
    got = M.greedy_select(*[a.to(cuda) for a in cpu], **kw)
    torch.cuda.synchronize()
    assert M.launches == n0 + 1
    same(got, M.greedy_select(*cpu, **kw))


def _edge_rows(nseg=3001):
    """All-candidate rows (each segment selected), a row without a
    candidate, a start exactly at lengths - min_tail, padding rows with
    negative lengths: numpy (p, off, e, has, lengths)."""
    p = np.repeat(np.arange(nseg, dtype=np.int32)[None, :] * 4, 6, 0)
    e = p + 48
    has = np.ones((6, nseg), bool)
    has[1] = False
    e[2, 1000] = 4 * 1000 + 4
    lengths = np.array([4 * nseg, 4 * nseg, 4 * 1000 + 12, -5, -70000,
                        4 * nseg], np.int32)
    return p, np.ones_like(p), e, has, lengths


def test_greedy_on_synthetic_rows(cuda):
    """Rows of length 0, 3 and 11, rows shorter than c0, segment counts
    that are not a multiple of 32, 1-13 rows, the edge rows of
    tests/test_torch_greedy_rounds.py (c0 0 and 4096, min_match 0), and
    two host threads launching at once (the Writer's threads do)."""
    for seed, B, nseg, seg_size, c0 in ((1, 13, 1000, 4, 0),
                                        (2, 5, 257, 8, 0),
                                        (3, 1, 4096, 4, 512),
                                        (4, 7, 3000, 8, 4096),
                                        (5, 3, 40000, 4, 0)):
        p, off, e, has, lengths = greedy_synthetic(seed, B, nseg, seg_size,
                                                   c0)
        for min_tail in (4, 12):
            _both(cuda, (p, off, e, has, lengths), min_tail=min_tail, c0=c0)
    edge = _edge_rows()
    for kw in (dict(min_tail=12), dict(min_tail=12, c0=4096),
               dict(min_tail=4, min_match=0)):
        _both(cuda, edge, **kw)
    inputs = [greedy_synthetic(6 + i, 64, 32768, 4) for i in range(2)]
    cpu = [[torch.from_numpy(a) for a in x] for x in inputs]
    want = [M.greedy_select(*x, min_tail=4) for x in cpu]
    got = [None, None]

    def launch(i):
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            for _ in range(20):
                got[i] = M.greedy_select(*[a.to(cuda) for a in cpu[i]],
                                         min_tail=4)
            stream.synchronize()
    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        same(g, w)


def test_greedy_at_the_path_shapes(cuda):
    """The zstd sort write's batch (64 rows of 128 KiB, seg_size 4 and
    8, min_tail 4) and the LZ4 one (128 rows of a 64 KiB window and a
    64 KiB block, c0 = 65536, min_tail 12), candidates from the port's
    find_segment_matches on the card."""
    data = mixed_corpus(np.random.default_rng(113), 128 * BLOCK + BLOCK)
    X = torch.from_numpy(data[: 64 * N].reshape(64, N)).to(cuda)
    lens = torch.full((64,), N, dtype=torch.int32, device=cuda)
    for seg_size in (4, 8):
        p, off, e, has = M.find_segment_matches(
            X, lens, seg_size=seg_size, max_len=48, min_tail=4,
            end_margin=0, max_offset=(1 << 17) - 1, window=8)
        _both(cuda, [a.cpu().numpy() for a in (p, off, e, has, lens)],
              min_tail=4)
    rows = np.stack([data[i * BLOCK: i * BLOCK + 2 * BLOCK]
                     for i in range(128)])
    X = torch.from_numpy(rows).to(cuda)
    lens = torch.full((128,), 2 * BLOCK, dtype=torch.int32, device=cuda)
    min_ref = torch.zeros(128, dtype=torch.int32, device=cuda)
    min_ref[::16] = BLOCK
    p, off, e, has = M.find_segment_matches(
        X, lens, seg_size=4, max_len=48, max_back=4, dual=True,
        ctx_len=BLOCK, min_ref=min_ref)
    _both(cuda, [a.cpu().numpy() for a in (p, off, e, has, lens)],
          min_tail=12, c0=BLOCK)
