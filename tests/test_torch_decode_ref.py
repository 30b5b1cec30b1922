"""K4's plain version against the reference kernel, on the reference's own
packed rows.

The JAX package's decode_frames runs with its fused route forced
(pallas_decode.decode_blocks_smem in interpret mode); every array its
_try_decode_smem passes to the kernel is recorded and fed, unchanged, to
the port's ops/decode.decode_blocks on the CPU.  On every row the
reference accepts, the port's ok flag is 1 and its bytes equal the
reference's output row cut to its advance (tolerance: none, bytes).  The
frames cover 4- and 1-stream Huffman, raw and RLE literals, predefined,
RLE and compressed FSE tables, a 3-block frame whose repcodes carry
across blocks, and stock libzstd frames."""

import numpy as np
import pytest

from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.testing import golden
from test_torch_decode_inputs import (capture_reference, own_frames,
                                      port_on_reference_rows,
                                      reference_row_bytes, section_modes,
                                      stock_frames)

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _check_rows(calls):
    """Every row of every frame the reference accepts whole (ok, and each
    block's advance as predicted): port ok and equal bytes.  Returns the
    number of rows compared."""
    rows = 0
    for args, (out_w, stat) in calls:
        meta = args[4]
        out, pstat, row_off = port_on_reference_rows(args)
        good = (stat[:, 1] == 1) & (stat[:, 0] == meta[:, 1])
        frame = np.cumsum((meta[:, 0] & D.DMODE_FRAME_START) != 0)
        accepted = np.array([good[frame == frame[r]].all()
                             for r in range(len(meta))])
        for r in np.nonzero(accepted)[0]:
            n = int(stat[r, 0])
            assert pstat[r, 1] == 1, r
            assert pstat[r, 0] == n, r
            got = out[row_off[r]: row_off[r] + n].tobytes()
            assert got == reference_row_bytes(out_w, r, n), r
            rows += 1
    return rows


def test_plain_k4_matches_reference_on_own_frames(monkeypatch):
    frames, raws = own_frames()
    lits, seqs = section_modes(frames)
    assert {"huf4", "huf1", "raw", "rle"} <= lits, lits
    assert {"rle", "compressed"} <= seqs, seqs
    res, calls = capture_reference(monkeypatch, frames, raws)
    assert res == raws
    assert calls and all((s[:, 1] == 1).all() for _, (_, s) in calls)
    assert _check_rows(calls) == sum(len(a[4]) for a, _ in calls)


def test_plain_k4_matches_reference_on_stock_frames(monkeypatch):
    frames, raws = stock_frames()
    lits, seqs = section_modes(frames)
    assert {"huf4", "raw"} <= lits and "predefined" in seqs, (lits, seqs)
    res, calls = capture_reference(monkeypatch, frames, raws)
    assert res == raws
    # the reference accepts every frame but the long-window one, whose
    # offsets exceed its 128 KiB ring (tests/test_torch_decode_limits.py)
    assert len(calls) == 1
    meta = calls[0][0][4]
    last = np.nonzero(meta[:, 0] & D.DMODE_FRAME_START)[0][-1]
    assert _check_rows(calls) == last
