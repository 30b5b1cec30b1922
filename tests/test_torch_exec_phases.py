"""K6's phase mirror (ops/exec_blocks.exec_mirror: the CUDA kernel's
per-row checks, the chain's verdicts, the scatter, pointer doubling and
the serial arm, in numpy) against the plain walk and the Pallas kernel in
interpret mode.

Bytes and ok flags must be equal (tolerance: none)."""

import numpy as np
import torch

from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import exec_blocks as X
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.damage import damaged_frames
from test_torch_cuda_inputs import k6_cases, stock_frames
from test_torch_lanes_inputs import (archive_parts, blocks_per_frame,
                                     capture_k6, mixed_archive)


def _damaged_frame_calls(monkeypatch):
    """K6's calls on the CPU lane route for 24 damaged copies of stock
    libzstd frames (testing/damage.damaged_frames; copies the host parse
    or the lane decoders reject never reach K6): [(args, out_size)]."""
    frames, raws = stock_frames()
    calls = []
    real = X.execute_blocks

    def spy(*a, **kw):
        calls.append((a[:7], a[7]))
        return real(*a, **kw)

    monkeypatch.setattr(X, "execute_blocks", spy)
    for i, fr in damaged_frames(frames[:-1], 17, 24):
        try:
            ZD.decode_frames_lanes([fr], [len(raws[i])], device="cpu")
        except FormatError:
            pass        # the route's verdict on a damaged frame
    monkeypatch.setattr(X, "execute_blocks", real)
    assert calls
    return [([t.numpy() for t in a], n) for a, n in calls]


def test_phases_match_plain(monkeypatch):
    """Random frames and damaged copies of them (rows failing at their
    first or a later sequence; rows that overlap the one before, which
    send their frame to the serial arm), a match 131071 bytes back
    followed by overlapping copies, and the rows the lane route gives
    K6 for damaged stock frames."""
    serial = failed = mid = 0
    for args, size in k6_cases() + _damaged_frame_calls(monkeypatch):
        t = [torch.from_numpy(a) for a in args]
        out, ok = X.execute_blocks(*t, size)
        got = X.exec_mirror(*t, size)
        assert torch.equal(got[0], out) and torch.equal(got[1], ok)
        rows = X.row_checks(args[0].shape[1], *args[1:5])
        serial += got[2]
        failed += int((ok == 0).any())
        mid += sum(1 for hdr, fail, *_ in rows if hdr and 0 < fail < X.NO_FAIL)
    assert serial > 0 and failed > 0 and mid > 0


def test_phases_match_pallas(monkeypatch):
    """The reference's own rows (its lane route with K6 forced, the
    Pallas kernel in interpret mode) on four 256 KiB frames of the mixed
    corpus: each block's bytes equal the kernel's output row."""
    archive, data = mixed_archive()
    frames, sizes, hints = archive_parts(archive)
    res, calls = capture_k6(monkeypatch, frames, sizes, hints)
    assert b"".join(res) == data and len(calls) == 1
    (lit_words, ll, ml, off, meta), ref = calls[0]
    per_frame = blocks_per_frame(frames, sizes)
    BL = sum(per_frame)
    chain = np.concatenate([[0], np.cumsum(per_frame)]).astype(np.int32)
    fo = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    t = lambda a: torch.from_numpy(np.array(a))
    out, ok, serial = X.exec_mirror(
        t(lit_words[:BL].astype("<i4").view(np.uint8)), t(ll[:BL]),
        t(ml[:BL]), t(off[:BL]), t(meta[:BL]), t(chain), t(fo), int(fo[-1]))
    assert ok.all() and serial == 0
    r = 0
    for f, nb in enumerate(per_frame):
        for _ in range(nb):
            content, d_off = int(meta[r, 1]), int(meta[r, 2])
            a = int(fo[f]) + d_off
            assert out[a: a + content].numpy().tobytes() == \
                ref[r].astype("<i4").tobytes()[:content], (f, r)
            r += 1
    assert r == 8
