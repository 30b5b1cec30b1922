"""K7's plain version against the Pallas kernel (interpret mode).

Outputs up to each row's n_seq, n_seq and cover_end must be equal
(tolerance: none; past n_seq the Pallas outputs are not written)."""

import numpy as np

from test_torch_hash_inputs import (block_rows, k7_plain, k7_reference,
                                    small_rows)


def _same(got, ref):
    n = ref[3]
    np.testing.assert_array_equal(got[3], n)
    np.testing.assert_array_equal(got[4], ref[4])
    for i in range(len(n)):
        for k in range(3):
            np.testing.assert_array_equal(got[k][i, : n[i]], ref[k][i, : n[i]])
        assert not got[0][i, n[i]:].any() and not got[1][i, n[i]:].any()
    assert got[0].shape == ref[0].shape


def test_plain_k7_small_rows():
    """tests/test_pallas_parse.py's four 16 KiB rows: text, mixed, zeros
    (one sequence) and period-337 repeats."""
    got = k7_plain("small")
    _same(got, k7_reference(*small_rows()))
    assert got[3][2] == 1


def test_plain_k7_full_blocks():
    """128 KiB log-like (> 4096 sequences) and mixed rows, and text as a
    short last block."""
    got = k7_plain("blocks")
    _same(got, k7_reference(*block_rows()))
    assert got[3][0] > 8192 and got[4][2] <= block_rows()[1][2]
