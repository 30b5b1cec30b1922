"""The redesigned K7 (rounds of the hash walk on a warp) and K6 (checks,
verdicts, scatter and pointer doubling, with a serial arm) on the card
against their plain versions.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are sequences, counts, bytes and flags and must be equal
(tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.ops import exec_blocks as X
from libzseek_tpu_torch.ops import hash_parse as HP
from libzseek_tpu_torch.testing.corpus import text_corpus
from test_torch_cuda_inputs import (cuda_device, k6_batch, k6_cases,
                                    k7_edge_rows, same)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def test_k7_rounds_match_plain(cuda):
    """The rows that drive every arm of the round walk, then 64 rows of
    128 KiB of text (each reaches cap)."""
    X7, lens = k7_edge_rows()
    text = text_corpus(np.random.default_rng(37), 64 << 17).reshape(64, -1)
    for x, n in ((X7, lens), (text, np.full(64, 1 << 17, np.int32))):
        args = [torch.from_numpy(x), torch.from_numpy(n)]
        same(HP.hash_parse(*[a.to(cuda) for a in args]), HP.hash_parse(*args))


def test_k6_phases_match_plain(cuda):
    """Random frames, damaged copies (some frames on the serial arm) and
    a match 131071 bytes back; then rows of ~1,000 sequences (the row
    checks' scan over several chunks).  Every other call bounds the
    doubling rounds by the frames' matches (match_bound), as the lane
    route does."""
    before = X.serial_frames()
    cases = k6_cases() + [k6_batch(np.random.default_rng(41), 3, S=2048,
                                   LW=1 << 16, blocks=(1, 2), blk=60000)]
    for i, (args, size) in enumerate(cases):
        t = [torch.from_numpy(a) for a in args]
        bound = X.match_bound(args[2], args[5]) if i % 2 else None
        got = X.execute_blocks(*[a.to(cuda) for a in t], size,
                               max_matches=bound)
        ref = X.execute_blocks(*t, size)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)
    assert int(cases[-1][0][4][:, 0].max()) > 256
    assert X.serial_frames() > before
