"""Where the port's K4 widens the reference's limits, and where it must
refuse.

The reference executes into a 128 KiB-offset ring: a match reaching
further back sets ok = 0 and sends the batch to its XLA passes.  The
port's K4 copies from the frame's own output, so the same packed rows
decode, byte for byte equal to the input.  A corrupt frame (leftover
bits after the sequence walk, or a flipped bit that stock libzstd also
rejects) raises FormatError; no wrong bytes come back."""

import numpy as np
import pytest

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops.zstd_decode import decode_frames
from libzseek_tpu_torch.testing import golden
from test_torch_decode_inputs import (capture_reference,
                                      leftover_bits_frame, multiblock,
                                      port_on_reference_rows, stock_frames)

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def test_offsets_past_the_reference_ring(monkeypatch):
    frames, raws = stock_frames()
    rng = np.random.default_rng(17)
    blk = rng.integers(0, 256, 200 * 1024, np.uint8).tobytes()
    # the port's own writer: its long-distance pre-pass matches whole
    # blocks 200 KiB back
    own = ZstdCodec(device="cpu").compress_frames([blk + blk])[0]
    frames, raws = [frames[-1], own], [raws[-1], blk + blk]
    res, calls = capture_reference(monkeypatch, frames, raws)
    assert res == raws                      # through the XLA fallback
    (args, (_, stat)), = calls
    meta = args[4]
    start = np.nonzero(meta[:, 0] & D.DMODE_FRAME_START)[0]
    for f, (a, b) in enumerate(zip(start, list(start[1:]) + [len(meta)])):
        assert (stat[a:b, 1] == 0).any(), f   # the reference's ring refuses
    out, pstat, _ = port_on_reference_rows(args)
    assert (pstat[:, 1] == 1).all()
    assert out.tobytes() == b"".join(raws)
    assert decode_frames(frames, [len(r) for r in raws], device="cpu") == raws


def test_corrupt_frames_raise():
    fr, raw = leftover_bits_frame()
    with pytest.raises(RuntimeError):
        golden.zstd_frame_decompress(fr, len(raw))
    with pytest.raises(FormatError):
        decode_frames([fr], [len(raw)], device="cpu")
    # a flipped bit near the top of a sequence stream (its initial FSE
    # states): the first such flip stock libzstd rejects must raise here
    raw = multiblock(np.random.default_rng(91))[:100 * 1024]
    good = ZstdCodec(device="cpu").compress_frames([raw])[0]
    assert decode_frames([good], [len(raw)], device="cpu") == [raw]
    for bit in range(8, 8 * 32):
        bad = bytearray(good)
        bad[len(bad) - 1 - bit // 8] ^= 1 << (bit % 8)
        try:
            golden.zstd_frame_decompress(bytes(bad), len(raw))
        except RuntimeError:
            break
    else:
        pytest.fail("no flip of the stream's top bytes is rejected")
    with pytest.raises(FormatError):
        decode_frames([bytes(bad)], [len(raw)], device="cpu")
