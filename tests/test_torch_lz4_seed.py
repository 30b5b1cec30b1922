"""K5's seed: a batch whose row 0 is the previous block of the frame
that its first row continues (min_ref[0] = 0, as the codec lays out a
frame split across batches).  The chain starting at row 0 must first
insert row 0's positions, as the reference's grid step 0 does; plain K5
must equal the Pallas kernel in interpret mode on 64 KiB rows."""

import numpy as np

from test_torch_lz4_inputs import BLOCK, both_k5, mixed_rows


def test_seeded_first_row():
    x = mixed_rows(41, 4)
    # text-like block as the context, then that block again (a match at
    # distance 64 KiB - 3 bytes is only reachable through the seed),
    # then a frame start, then a zero block
    D = np.zeros((4, BLOCK), np.uint8)
    D[0] = x[:BLOCK]
    D[1, :BLOCK - 7] = x[7: BLOCK]
    D[2] = x[BLOCK: 2 * BLOCK]
    lens = np.array([2 * BLOCK - 7, 2 * BLOCK, 2 * BLOCK], np.int32)
    min_ref = np.array([0, 2 * BLOCK, 2 * BLOCK], np.int32)
    ref, got = both_k5(D, lens, min_ref)
    assert got == ref
    # without the seed the first row compresses worse: the seed did work
    _, unseeded = both_k5(D, lens, np.array([BLOCK, 2 * BLOCK, 2 * BLOCK],
                                            np.int32))
    assert len(got[0]) < len(unseeded[0])
