"""K6's plain version against the reference kernel on hand-made rows:
overlapping match copies at offsets 1, 2, 3, 4, 7, 31, 32 and 33, matches
that reach into the previous block and to the frame's first byte, and a
second frame in the same batch; then the port's refusals (tolerance:
none, bytes and flags)."""

import numpy as np
import torch

from libzseek_tpu.ops.pallas_match import execute_blocks_smem
from libzseek_tpu_torch.ops import exec_blocks as X
from test_torch_lanes_inputs import check_rows

LW = 32768   # the reference's literal row, int32 words
S = 64


def _rows(blocks):
    """blocks: per frame, per block (literal bytes, [(ll, ml, off)]),
    block sizes multiples of 4.  Returns the reference's row arrays,
    per-frame block counts and frame sizes."""
    flat = [b for fr in blocks for b in fr]
    BL = max(8, len(flat))
    lit = np.zeros((BL, 4 * LW), np.uint8)
    ll = np.zeros((BL, S), np.int32)
    ml = np.zeros((BL, S), np.int32)
    off = np.ones((BL, S), np.int32)
    meta = np.zeros((BL, 3), np.int32)
    sizes = []
    r = 0
    for fr in blocks:
        d_off = 0
        for lits, seqs in fr:
            lit[r, : len(lits)] = np.frombuffer(lits, np.uint8)
            for j, (a, m, o) in enumerate(seqs):
                ll[r, j], ml[r, j], off[r, j] = a, m, o
            content = sum(a + m for a, m, _ in seqs)
            assert sum(a for a, _, _ in seqs) == len(lits)
            assert content % 4 == 0
            meta[r] = (len(seqs), content, d_off)
            d_off += content
            r += 1
        sizes.append(d_off)
    args = [lit.view("<i4"), ll, ml, off, meta]
    return args, [len(fr) for fr in blocks], sizes


def _case():
    rng = np.random.default_rng(29)
    lits = lambda n: rng.integers(0, 256, n, np.uint8).tobytes()
    overlap = [(a, m, o) for a, m, o in (
        (5, 9, 1), (3, 12, 2), (4, 10, 3), (2, 11, 4), (6, 20, 7),
        (31, 40, 31), (3, 64, 32), (33, 70, 33), (1, 6, 5))]
    pos = sum(a + m for a, m, _ in overlap)
    tail = (-pos) % 4          # block 0 ends on a multiple of 4
    if tail:
        overlap.append((tail, 0, 1))
        pos += tail
    b0 = (lits(sum(a for a, _, _ in overlap)), overlap)
    # block 1: a match reaching into block 0, then one to the frame's
    # first byte, then four trailing literals
    seqs1 = [(2, 30, 40), (0, 16, pos + 32), (4, 0, 1)]
    b1 = (lits(6), seqs1)
    # block 2: a long self-overlapping run and a far match
    seqs2 = [(4, 200, 1), (8, 300, 250), (4, 0, 1)]
    b2 = (lits(16), seqs2)
    # frame 2: its own first bytes only
    seqs3 = [(7, 25, 7), (1, 3, 2)]
    b3 = (lits(8), seqs3)
    blocks = [[b0, b1, b2], [b3]]
    return blocks


def test_plain_k6_overlap_offsets_match_pallas():
    args, per_frame, sizes = _rows(_case())
    ref = np.asarray(execute_blocks_smem(*[np.asarray(a) for a in args],
                                         interpret=True))
    assert check_rows(args, ref, per_frame, sizes) == 4


def test_k6_refuses_sequences_outside_the_frame():
    """A match before the frame's first byte, or past the block's size,
    sets ok = 0 for its block and the rest of its frame's chain; the
    other frame is untouched.  (The reference would read stale ring
    bytes; the port's lane route raises FormatError.)"""
    args, per_frame, sizes = _rows(_case())
    BL = sum(per_frame)
    frame_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:BL]))
    for bad in ((0, 8, 9999), (0, 10**6, 1)):
        # prepend the bad sequence to block 1
        seqs = [a.copy() for a in args[1:4]]
        for k, v in enumerate(bad):
            seqs[k][1] = np.concatenate([[v], seqs[k][1][:-1]])
        meta = args[4].copy()
        meta[1, 0] += 1
        _, ok = X.execute_blocks(
            t(args[0].view(np.uint8)), *[t(a) for a in seqs], t(meta),
            torch.tensor([0, 3, 4], dtype=torch.int32),
            torch.from_numpy(frame_off), int(frame_off[-1]))
        assert ok.tolist() == [1, 0, 0, 1], (bad, ok)
