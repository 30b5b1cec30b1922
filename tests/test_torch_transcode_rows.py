"""The port's transcode row builder (ops/zstd_decode.transcode_rows)
against the rows the JAX package's _try_decode_transcode hands its
kernel: meta (mode bits with DMODE_TRANSCODE and DMODE_FRAME_START,
sizes, frame offsets, stream bits), FSE tables, the payload words and,
for device literals, the Huffman peek tables.  With a chunk of 2 rows
(ZN_DECODE_CHUNK=2 on the reference, TRANSCODE_CHUNK = 2 here) a 768 KiB
frame with usable hints starts a chunk mid-frame (test_decode_smem.py:101);
frames without hints split only at their boundaries."""

import numpy as np

from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_transcode_inputs import (capture_transcode, chain_frames,
                                         check_builder, jax_frames,
                                         large_frame, port_rows)


def _starts(meta) -> list:
    return np.nonzero(meta[:, 0] & D.DMODE_FRAME_START)[0].tolist()


def test_rows_match_reference_mid_frame_chunks(monkeypatch):
    raw = large_frame()
    frames, jh, ph = jax_frames([raw])
    res, calls = capture_transcode(monkeypatch, frames, [len(raw)], jh,
                                   chunk=2)
    assert res == [raw] and len(calls) == 2
    monkeypatch.setattr(ZD, "TRANSCODE_CHUNK", 2)
    rows, dtabs = port_rows(frames, [len(raw)], ph)
    check_builder(calls, rows, dtabs)
    assert _starts(rows["meta"]) == [0, 2]          # row 2 is mid-frame
    assert rows["meta"][2, 2] > 0
    assert rows["chain"].tolist() == [0, 2, 4]


def test_rows_match_reference_frame_splits(monkeypatch):
    frames, raws = chain_frames(np.random.default_rng(5))
    sizes = [len(r) for r in raws]
    res, calls = capture_transcode(monkeypatch, frames, sizes,
                                   host_literals=False, chunk=2)
    assert res == raws
    monkeypatch.setattr(ZD, "TRANSCODE_CHUNK", 2)
    rows, dtabs = port_rows(frames, sizes, host_literals=False)
    check_builder(calls, rows, dtabs)
    assert _starts(rows["meta"]) == [0, 3, 6]      # frame starts only
    assert rows["chain"].tolist() == [0, 3, 6, 9]
    assert (rows["meta"][:, 0] & (D.DMODE_HUF4 | D.DMODE_HUF1)).sum() >= 6
