"""K4's transcode arm (plain, ops/decode.transcode_blocks) against the
reference kernel (pallas_decode._decode_kernel, interpret mode) on the
rows the JAX package's transcode route builds, with its host literals on
(every row DMODE_DIRECT | DMODE_LIT_HOST, sequences only) and off (the
Huffman streams decode on the device: HUF4 and HUF1 rows).  Frames: the
port's codec on the cases of tests/test_decode_smem.py (seed 91), a
1-stream Huffman text and the hand-written RLE frame, and stock libzstd
at levels 1, 3 and 19 with a long-window frame (a match ~400 KiB back,
inside the token's 28 bits).  Stat, every token word and every literal
word equal the reference's (tolerance: none)."""

import numpy as np
import pytest

from libzseek_tpu_torch.ops import decode as D
from test_torch_transcode_inputs import (capture_transcode, check_rows,
                                         own_frames, stock_frames)


@pytest.mark.parametrize("host_literals", [True, False],
                         ids=["host_literals", "device_literals"])
def test_plain_transcode_matches_reference(monkeypatch, host_literals):
    f1, r1 = own_frames()
    f2, r2 = stock_frames()
    frames, raws = f1 + f2, r1 + r2
    res, calls = capture_transcode(monkeypatch, frames,
                                   [len(r) for r in raws],
                                   host_literals=host_literals)
    assert res == raws
    meta = np.concatenate([a[4] for a, _ in calls])
    if host_literals:
        assert (meta[:, 0] & D.DMODE_LIT_HOST).all()
    else:
        for bit in (D.DMODE_HUF4, D.DMODE_HUF1, D.DMODE_LIT_HOST):
            assert (meta[:, 0] & bit).any(), bit
    assert all((s[:, 1] == 1).all() for _, (_, s) in calls)
    assert check_rows(calls) == len(meta)
