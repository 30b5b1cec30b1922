"""K5's plain version (ops/lz4_emit.py) against the Pallas kernel
_lz4_kernel in interpret mode, same rows: the payload bytes and lengths
must be equal (tolerance: none), and the rows decode through liblz4."""

import numpy as np
import pytest

from libzseek_tpu_torch.format import lz4f
from libzseek_tpu_torch.testing import golden
from test_torch_lz4_inputs import BK, both_k5, rows_of, vocab_stream

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def test_linked_rows():
    """Three linked 4 KiB blocks of one frame, with cross-block matches."""
    s = vocab_stream()
    D = rows_of(s, BK)
    ref, got = both_k5(D, np.full(3, 2 * BK, np.int32),
                       np.array([BK, BK, 2 * BK], np.int32))
    assert got == ref
    frame = lz4f.assemble_frame([(p, False) for p in got], 3 * BK,
                                block_independent=False)
    assert golden.lz4f_decompress(frame) == s.tobytes()


def test_frames_starting_mid_batch():
    """Eight rows in three frames (3 + 4 + 1 blocks): frames begin at
    rows 3 and 7, the last block of the second frame is short, and the
    third frame repeats the second's bytes, which it must not reach."""
    s = vocab_stream(24, 8 * BK)
    s[7 * BK:] = s[6 * BK: 7 * BK]
    D = rows_of(s, BK)
    lens = np.full(8, 2 * BK, np.int32)
    lens[6] = BK + 1000
    D[7, 1000:] = 0
    starts = {0, 3, 7}
    min_ref = np.array([(i + 1) * BK if i in starts else i * BK
                        for i in range(8)], np.int32)
    ref, got = both_k5(D, lens, min_ref)
    assert got == ref
    for lo, hi, n in ((0, 3, 3 * BK), (3, 7, 3 * BK + 1000), (7, 8, BK)):
        frame = lz4f.assemble_frame([(p, False) for p in got[lo:hi]], n,
                                    block_independent=False)
        raw = b"".join(D[i + 1, : lens[i] - BK].tobytes()
                       for i in range(lo, hi))
        assert golden.lz4f_decompress(frame) == raw
