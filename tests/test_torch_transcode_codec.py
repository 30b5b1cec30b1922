"""ZstdCodec(device="cpu", decoder="auto"), whose host delivery takes the
transcode route: a corrupt frame (its sequence stream not consumed
exactly) fails K4's transcode stat, falls back to the fused route
(counted) and raises FormatError there; so does a frame whose offset
the token's 28 bits cannot hold; to_device=True takes the fused route,
as in the reference; LZ4 archives refuse the zstd-only decoders and
take "auto" (the default)."""

import io

import pytest
import torch

import libzseek_tpu_torch as port
from libzseek_tpu_torch.errors import FormatError, ParameterError
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_cuda_inputs import leftover_bits_frame
from test_torch_transcode_inputs import far_offset_frame, own_frames


def test_transcode_codec_corrupt_frames_fall_back_and_raise():
    codec = port.ZstdCodec(device="cpu", decoder="auto")
    bad, raw = leftover_bits_frame()
    for frame, size in ((bad, len(raw)), (far_offset_frame(), 30)):
        before = ZD.routes["transcode_fallback_batches"]
        with pytest.raises(FormatError):
            codec.decompress_frames([frame], [size])
        assert ZD.routes["transcode_fallback_batches"] == before + 1


def test_transcode_codec_device_delivery_and_lz4():
    frames, raws = own_frames()
    codec = port.ZstdCodec(device="cpu", decoder="auto")
    before = ZD.routes["transcode_batches"]
    got = codec.decompress_frames(frames, [len(r) for r in raws],
                                  to_device=True)
    assert ZD.routes["transcode_batches"] == before
    assert all(isinstance(g, torch.Tensor) for g in got)
    assert b"".join(g.numpy().tobytes() for g in got) == b"".join(raws)
    sink = io.BytesIO()
    w = port.Writer(sink, "lz4", device="cpu", min_frame_size=4096)
    w.write(raws[0])
    w.close()
    for decoder in ("fused", "lanes", "transcode"):
        with pytest.raises(ParameterError):
            port.Reader(sink.getvalue(), device="cpu", decoder=decoder)
    r = port.Reader(sink.getvalue(), device="cpu")
    assert r._hints is None and r.pread_full(len(raws[0]), 0) == raws[0]
