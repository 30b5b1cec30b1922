"""The port's LZ4 decode routes are the JAX package's: frames delivered to
the host go through the native block decoder, so a default
Reader(device="cpu"), open_reader and LZ4Codec.decompress_frames never
call the card's decoder (ops/lz4_decode.lz4_decode_frames, here made to
raise), and return the input, equal to the JAX LZ4Codec's host route;
frames kept on the device (device_cache=True, cache_frames=0) go
through the card's decoder (its plain version on the CPU) and return
the input too (bytes; tolerance: none)."""

import io

import numpy as np
import pytest

import libzseek_tpu_torch as port
from libzseek_tpu.runtime.codec import LZ4Codec as JCodec
from libzseek_tpu_torch.format.seek_table import FrameLog
from libzseek_tpu_torch.runtime import codec as C
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_inputs import build_native_runtime

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")

KIB = 1024


def _archive(independent: bool):
    """(archive, data, frames): 192 KiB of mixed_corpus (seed 61)
    in 64 KiB frames written by the port's Writer (linked blocks), or by
    stock liblz4 with independent blocks plus a seek table."""
    data = mixed_corpus(np.random.default_rng(61), 192 * KIB).tobytes()
    if independent:
        frames = [golden.lz4f_compress(data[p: p + 64 * KIB],
                                       block_independent=True)
                  for p in range(0, len(data), 64 * KIB)]
        log = FrameLog()
        for f in frames:
            log.log_frame(len(f), 64 * KIB)
        return b"".join(frames) + log.serialize(), data, frames
    sink = io.BytesIO()
    w = port.Writer(sink, "lz4", device="cpu", min_frame_size=64 * KIB)
    for pos in range(0, len(data), 64 * KIB):
        w.write(data[pos: pos + 64 * KIB])
    w.close()
    archive = sink.getvalue()
    r = port.Reader(archive, device="cpu")
    frames = [r._read_frame_bytes(i) for i in range(3)]
    return archive, data, frames


def test_host_delivery_takes_the_native_route(monkeypatch):
    def card(*a, **k):
        raise AssertionError("the card's LZ4 decoder was called")

    monkeypatch.setattr(C, "lz4_decode_frames", card)
    build_native_runtime()
    for independent in (False, True):
        archive, data, frames = _archive(independent)
        sizes = [64 * KIB] * 3
        for r in (port.Reader(archive, device="cpu"),
                  port.open_reader(io.BytesIO(archive), device="cpu")):
            assert isinstance(r._codec, port.LZ4Codec) and r._hints is None
            assert r.pread_full(len(data), 0) == data
            assert r.pread_full(7000, 100 * KIB) == \
                data[100 * KIB: 100 * KIB + 7000]
            r.close()
        got = port.LZ4Codec(device="cpu").decompress_frames(frames, sizes)
        assert got == JCodec().decompress_frames(frames, sizes)
        assert b"".join(got) == data


def test_device_delivery_takes_the_card_decoder(monkeypatch):
    calls = []
    real = C.lz4_decode_frames
    monkeypatch.setattr(C, "lz4_decode_frames",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    archive, data, frames = _archive(False)
    # device_cache: a span across frames 0 and 1, one decode each; no
    # cache: a span inside frame 2
    for kw, off, n, want in ((dict(device_cache=True), 30 * KIB, 80 * KIB, 2),
                             (dict(cache_frames=0), 130 * KIB, 50 * KIB, 1)):
        calls.clear()
        r = port.Reader(archive, device="cpu", **kw)
        assert r.pread_full(n, off) == data[off: off + n]
        r.close()
        assert len(calls) == want, (kw, calls)
