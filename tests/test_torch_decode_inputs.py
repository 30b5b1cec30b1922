"""Shared inputs of the read-path parity tests (tests/test_torch_decode*.py,
tests/test_torch_reader*.py).  It holds no tests.

The frames (tests/test_torch_cuda_inputs.py, JAX-free for the card) are
made from numpy seeds: the cases of tests/test_decode_smem.py (seed 91)
written by the port's codec and by stock libzstd.  `capture_reference` runs the JAX package's decode_frames
with its fused decode forced (interpret mode, transcode off, as
test_decode_smem.py does) and records every array its _try_decode_smem
hands to pallas_decode.decode_blocks_smem, with the kernel's outputs."""

import numpy as np
import torch

from libzseek_tpu.ops import pallas_decode as jpd
from libzseek_tpu.ops.zstd_decode import decode_frames as jax_decode_frames
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.format.seek_table import FrameLog
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_cuda_inputs import (  # noqa: F401  (re-exported)
    cases, leftover_bits_frame, multiblock, own_frames, rle_frame,
    stock_frames)


def capture_reference(monkeypatch, frames, raws):
    """JAX decode_frames under the forced fused route: (its per-frame
    results, [(args, (out, stat)) per decode_blocks_smem call] as numpy)."""
    monkeypatch.setenv("ZN_DECODE_SMEM", "force")
    monkeypatch.setenv("ZN_DECODE_TRANSCODE", "off")
    calls = []
    real = jpd.decode_blocks_smem

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(([np.asarray(a) for a in args],
                      tuple(np.asarray(o) for o in out)))
        return out

    monkeypatch.setattr(jpd, "decode_blocks_smem", spy)
    res = jax_decode_frames(frames, [len(r) for r in raws])
    return res, calls


def port_on_reference_rows(args, decode=D.decode_blocks):
    """The port's plain K4 (or `decode`, the same contract: its phases'
    mirror) fed the reference's packed rows unchanged, with the chain
    layout read off them: frames start at DMODE_FRAME_START rows and own
    the bytes meta[1] (the reference's block sizes) adds up to.  Returns
    (out, stat, each row's byte offset in out)."""
    lp, sq, dtabs, ftabs, meta = args
    starts = np.nonzero(meta[:, 0] & D.DMODE_FRAME_START)[0]
    chain = np.append(starts, len(meta)).astype(np.int32)
    sizes = [int(meta[a:b, 1].sum()) for a, b in zip(chain, chain[1:])]
    frame_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    t = torch.from_numpy
    out, stat = decode(
        t(lp.astype(np.int32)), t(sq.astype(np.int32)),
        t(dtabs.astype(np.int32)), t(ftabs.astype(np.int32)),
        t(meta.astype(np.int32)), t(chain), t(frame_off), int(frame_off[-1]))
    stat = stat.numpy()
    row_off = np.zeros(len(meta), np.int64)
    for f, (a, b) in enumerate(zip(chain, chain[1:])):
        row_off[a:b] = frame_off[f] + np.concatenate(
            [[0], np.cumsum(stat[a:b - 1, 0])])
    return out.numpy(), stat, row_off


def reference_row_bytes(out_words, r, n):
    """The first n bytes of the reference's output row r."""
    return out_words[r].astype("<i4").tobytes()[:n]


def check_rows(calls):
    """Every row of every frame the reference accepts whole (ok, and each
    block's advance as predicted): the port's plain K4 fed the same rows
    gives ok and equal bytes.  Returns the number of rows compared."""
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


def section_modes(frames):
    """The literal-section kinds ("raw", "rle", "huf4", "huf1",
    "treeless") and sequence-table modes ("predefined", "rle",
    "compressed", "repeat") the frames' compressed blocks use."""
    lit_kinds, seq_modes = set(), set()
    names = ("predefined", "rle", "compressed", "repeat")
    for data in frames:
        pos = zf.parse_frame_header(data, 0).header_size
        state = {}
        while True:
            btype, bsize, last = zf.parse_block_header(data, pos)
            pos += 3
            if btype == zf.BLOCK_COMPRESSED:
                b0 = data[pos]
                lt, sf = b0 & 3, (b0 >> 2) & 3
                lit_kinds.add(("raw", "rle")[lt] if lt < 2 else
                              "treeless" if lt == 3 else
                              "huf1" if sf == 0 else "huf4")
                _, _, _, p = ZD._parse_lit_section(data, pos, state,
                                                   ZD._HufReg())
                n = data[p]
                if n:
                    p += 1 if n < 128 else 2 if n < 255 else 3
                    m = data[p]
                    seq_modes |= {names[(m >> s) & 3] for s in (6, 4, 2)}
                pos += bsize
            else:
                pos += bsize if btype == zf.BLOCK_RAW else 1
            if last:
                break
    return lit_kinds, seq_modes


def archive(frames, raws):
    """A seekable archive of ready-made frames (stock libzstd's): the
    frames, then the port's seek table."""
    log = FrameLog()
    for fr, raw in zip(frames, raws):
        log.log_frame(len(fr), len(raw))
    return b"".join(frames) + log.serialize()
