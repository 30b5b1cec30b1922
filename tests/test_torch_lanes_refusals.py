"""The lane route's refusals: an unknown decoder and the lane decoder on
an LZ4 archive raise ParameterError; corrupt frames raise FormatError
(a stream with leftover bits, a truncated sequence stream, a match
before the frame's start, a sidecar with too few anchors)."""

import io

import numpy as np
import pytest

import libzseek_tpu_torch as port
from libzseek_tpu_torch.errors import FormatError, ParameterError
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import text_corpus
from test_torch_cuda_inputs import leftover_bits_frame, rle_frame


def test_unknown_decoder_and_lz4_lanes_raise():
    with pytest.raises(ParameterError):
        port.ZstdCodec(device="cpu", decoder="xla")
    sink = io.BytesIO()
    w = port.Writer(sink, "lz4", device="cpu", min_frame_size=4096)
    w.write(b"lanes " * 1000)
    w.close()
    with pytest.raises(ParameterError):
        port.Reader(sink.getvalue(), device="cpu", decoder="lanes")
    assert port.Reader(sink.getvalue(), device="cpu").pread_full(
        12, 6) == b"lanes lanes "
    sink = io.BytesIO()
    w = port.Writer(sink, device="cpu", min_frame_size=4096)
    w.write(b"lanes " * 1000)
    w.close()
    with pytest.raises(ParameterError):
        port.open_reader(io.BytesIO(sink.getvalue()), device="cpu",
                         decoder="sideways")
    r = port.open_reader(io.BytesIO(sink.getvalue()), device="cpu",
                         decoder="lanes")
    assert r.pread_full(12, 6) == b"lanes lanes "


def test_corrupt_frames_raise_format_error():
    bad, raw = leftover_bits_frame()
    with pytest.raises(FormatError):
        ZD.decode_frames_lanes([bad], [len(raw)], device="cpu")
    fr, raw = rle_frame()
    assert ZD.decode_frames_lanes([fr], [len(raw)], device="cpu") == [raw]
    # the same frame with offset code 5 (5 zero extra bits a sequence):
    # the first match reaches 29 bytes back from byte 10
    lits = fr[zf.parse_frame_header(fr, 0).header_size + 3:][:3]
    body = lits + bytes([10, 0b01010100, 10, 5, 17]) + bytes(6) + b"\x04"
    far = (zf.build_frame_header(300)
           + zf.build_block_header(zf.BLOCK_COMPRESSED, len(body), True)
           + body)
    with pytest.raises(FormatError, match="before its frame"):
        ZD.decode_frames_lanes([far], [len(raw)], device="cpu")
    with pytest.raises(FormatError, match="backward bitstream"):
        ZD.decode_frames_lanes([fr[:-1] + b"\x00"], [len(raw)], device="cpu")
    # a sidecar whose literal anchors stop early
    text = text_corpus(np.random.default_rng(71), 8192).tobytes()
    sink = io.BytesIO()
    w = port.Writer(sink, device="cpu", min_frame_size=8192)
    w.write(text)
    w.close()
    r = port.Reader(sink.getvalue(), device="cpu", decoder="lanes")
    frame, hints = r._read_frame_bytes(0), r._hints[0]
    assert ZD.decode_frames_lanes([frame], [len(text)], [hints],
                                  device="cpu") == [text]
    hints[0].lit.bitpos[0] = hints[0].lit.bitpos[0][:1]
    with pytest.raises(FormatError, match="too few literal anchors"):
        ZD.decode_frames_lanes([frame], [len(text)], [hints], device="cpu")
