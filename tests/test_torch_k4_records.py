"""K4's phases (csrc/decode.cu; their mirrors ops/decode.row_records,
compose, exec_plan and decode_mirror): each row's sequence stream walked
once with its repcodes symbolic, a frame's row transforms composed in
order, every offset checked in parallel, the serial walk's verdicts
along each chain, and execution by scatter and pointer doubling.  Held
to the plain walk (ops/decode._decode_plain) on the port's frames, stock
libzstd frames at levels 1, 3 and 19, a long-window frame, and damaged
rows and frames.  Bytes and flags: tolerance none."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.damage import damaged_frames, damaged_rows
from test_torch_decode_inputs import own_frames, stock_frames

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _same(args, n):
    ref = D.decode_blocks(*args, n)
    got = D.decode_mirror(*args, n)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    assert torch.equal(got[0], ref[0])
    return ref[1].numpy()


def test_records_and_composed_repcodes_on_small_frames():
    """Every frame decodes through the phases as through the plain walk,
    and each row's composed input repcodes equal the repcodes the serial
    walk carries into it (reset at each frame start)."""
    frames, raws = own_frames()
    sf, sr = stock_frames()
    frames, raws = frames + sf, raws + sr
    args, n, rows = ZD.k4_inputs(frames, [len(r) for r in raws],
                                 torch.device("cpu"))
    stat = _same(args, n)
    assert (stat[:, 1] == 1).all()
    sq, ft, mt, ch = args[1].numpy(), args[3], rows["meta"], rows["chain"]
    recs, walks, xforms = {}, {}, {}
    for r in range(len(mt)):
        if mt[r, 0] & D.DMODE_SEQ and mt[r, 13] > 0:
            recs[r], walks[r], xforms[r] = D.row_records(
                sq[r], ft[r].tolist(), mt[r])
        else:
            recs[r], walks[r], xforms[r] = [], dict(op=0, lpos=0), D.SYM_IN
    ins, _ = D.compose(mt, ch, xforms, walks)
    n_sym = 0
    for f in range(len(ch) - 1):
        rep = [1, 4, 8]
        for r in range(int(ch[f]), int(ch[f + 1])):
            if mt[r, 0] & D.DMODE_FRAME_START:
                rep = [1, 4, 8]
            assert ins[r] == rep, (f, r)
            if mt[r, 0] & D.DMODE_SEQ and mt[r, 13] > 0:
                walk = D._SeqWalk(D._Row(sq[r]), ft[r].tolist(), mt[r], rep)
                offs = [o for _, _, o in walk]
                assert offs == [D.resolve_sym(q[4], ins[r])
                                for q in recs[r]]
                n_sym += sum(q[4] >= D.SYM // 2 for q in recs[r])
    assert n_sym > 0   # some offsets come from repcodes a row inherits


def test_damaged_rows_and_frames():
    """Rows with one bit of a sequence stream flipped and frames with one
    bit flipped near a compressed block's end: the same stat (the advance
    up to the failing sequence, ok 0, zeros for the rest of the chain)
    and the same bytes as the plain walk, failures mid-row among them."""
    frames, raws = stock_frames()
    frames, raws = frames[-6:], raws[-6:]
    args, n, _ = ZD.k4_inputs(frames, [len(r) for r in raws],
                              torch.device("cpu"))
    kinds = set()
    for a in damaged_rows(args, 5, 8):
        stat = _same(a, n)
        bad = np.nonzero(stat[:, 1] == 0)[0]
        if len(bad):
            kinds.add("mid" if stat[bad[0], 0] > 0 else "start")
    for i, fr in damaged_frames(frames, 7, 6):
        try:
            a, m, _ = ZD.k4_inputs([frames[i - 1], fr],
                                   [len(raws[i - 1]), len(raws[i])],
                                   torch.device("cpu"))
        except Exception:
            continue    # the host parse rejects it: no kernel runs
        stat = _same(a, m)
        if not stat[:, 1].all():
            kinds.add("frame")
    assert "mid" in kinds, kinds
