"""The LZ4 decoder's execution phases (ops/lz4_decode.resolve_records
after parse_records, numpy mirrors of csrc/lz4_decode.cu's expand and
pointer-doubling kernels) against the port's plain decoder
(_decode_plain, the XLA decoder in torch ops) on hand-written blocks:
offsets 1-31 overlapping their own match, offsets >= 32 with and without
overlap, a match reaching into the previous block of a linked frame,
long literal and match lengths, an uncompressed block, and the bad
cases.  out, out_lens and ok are integers: tolerance none."""

import numpy as np
import torch

from libzseek_tpu_torch.ops.lz4_decode import lz4_decode_frames
from test_torch_cuda_inputs import rows_of_blocks, seq_block
from test_torch_lz4_inputs import phases

M = 4096
F = 3 * M
BLOCK0 = seq_block([(b"ab", 2, 61), (b"XYZ", 1, 300),
                    (bytes(range(40)), 40, 200), (b"", 500, 20),
                    (b"q" * 300, 7, 100)], b"END0")


def _serial(frame, linked):
    """Byte-by-byte decode of [(block, uncompressed)]: the output."""
    out = bytearray()
    for blk, unc in frame:
        start = len(out)
        if unc:
            out += blk
            continue
        i = 0
        while True:
            tok = blk[i]
            i += 1
            ll = tok >> 4
            if ll == 15:
                while blk[i] == 255:
                    ll += 255
                    i += 1
                ll += blk[i]
                i += 1
            out += blk[i: i + ll]
            i += ll
            if i >= len(blk):
                break
            off = blk[i] | blk[i + 1] << 8
            i += 2
            ml = tok & 15
            if ml == 15:
                while blk[i] == 255:
                    ml += 255
                    i += 1
                ml += blk[i]
                i += 1
            assert 0 < off <= len(out) - (0 if linked else start)
            for _ in range(ml + 4):
                out.append(out[-off])
    return bytes(out)


def _plain(comp, clens, unc, linked, max_seqs=None):
    t = torch.from_numpy
    return [a.numpy() for a in lz4_decode_frames(
        t(comp), t(clens), t(unc), F, max_seqs=max_seqs, linked=linked)]


def test_copies_match_plain_and_input():
    """Self-overlapping copies (offsets 1, 2, 7, 31, 40), plain ones
    (offset 500), literal and match lengths with one and two extension
    bytes, a linked frame's match into its previous block, an
    uncompressed block, an absent block."""
    linked_frame = [(BLOCK0, False),
                    (seq_block([(b"", 100, 150), (b"k", 31, 64)], b"E1"),
                     False),
                    (b"RAW" * 50, True)]
    ind_frame = [(BLOCK0, False),
                 (seq_block([(b"hello world", 6, 40)], b"tail"), False)]
    for linked, frames in ((True, [linked_frame, ind_frame]),
                           (False, [ind_frame, ind_frame[:1]])):
        comp, clens, unc = rows_of_blocks(frames, M)
        got = phases(comp, clens, unc, F, linked)
        ref = _plain(comp, clens, unc, linked)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        assert got[2].all()
        for r, f in enumerate(frames):
            raw = _serial(f, linked)
            assert got[1][r] == len(raw)
            assert got[0][r, : len(raw)].tobytes() == raw
            assert not got[0][r, len(raw):].any()


def test_bad_frames_match_plain():
    """A match before the frame start, an offset past the block start of
    an independent frame, offset 0, a truncated block and an exhausted
    sequence budget: ok and out_lens equal the plain decoder's, and out
    where ok; the frame after each bad block still decodes."""
    good = [(BLOCK0, False), (seq_block([(b"xyz", 3, 9)], b"z"), False)]
    many = seq_block([(b"ab", 2, 6)] * 10, b"!")
    frames = [
        good,
        [(seq_block([(b"ab", 10, 8)], b"t"), False)],           # before
        [(BLOCK0, False), (seq_block([(b"", 50, 9)]), False)],  # past blk
        [(seq_block([(b"a", 0, 5)], b"t"), False)],              # offset 0
        [(BLOCK0[:-3], False), (BLOCK0, False)],                 # truncated
        [(many, False), (BLOCK0, False)],                        # budget
    ]
    comp, clens, unc = rows_of_blocks(frames, M)
    for linked in (True, False):
        for max_seqs in (None, 6):
            got = phases(comp, clens, unc, F, linked, max_seqs)
            ref = _plain(comp, clens, unc, linked, max_seqs)
            np.testing.assert_array_equal(got[2], ref[2])
            np.testing.assert_array_equal(got[1], ref[1])
            np.testing.assert_array_equal(got[0][ref[2]], ref[0][ref[2]])
            want = [True, False, linked, False, False, max_seqs is None]
            assert got[2].tolist() == want, (linked, max_seqs)
