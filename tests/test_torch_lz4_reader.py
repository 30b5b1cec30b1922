"""The port's Reader(device="cpu") on LZ4 archives: written by the
port's Writer, by the JAX package's default Writer (its sort parser),
and by stock liblz4 (linked and independent frames plus a seek table).
Every read returns the input bytes; so do the device-frame paths
(device_cache=True, cache_frames=0) and the codec's host route."""

import numpy as np
import pytest
import torch

from libzseek_tpu.runtime.writer import Writer as JWriter
from libzseek_tpu_torch import LZ4Codec, Reader, Writer
from libzseek_tpu_torch.format.seek_table import FrameLog
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_lz4_inputs import Sink, write_all

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def _reads(archive, data):
    offs = np.random.default_rng(5).integers(0, len(data) - 5000, 4)
    for kw in (dict(), dict(device_cache=True), dict(cache_frames=0)):
        r = Reader(archive, device="cpu", **kw)
        assert isinstance(r._codec, LZ4Codec)
        for off in offs.tolist()[: 2 if kw else 4]:
            assert r.pread_full(5000, off) == data[off: off + 5000]
        if kw.get("device_cache"):
            assert all(isinstance(c, torch.Tensor)
                       for c in r._cache._map.values())
        r.close()
    r = Reader(archive, device="cpu")
    got = b"".join(iter(lambda: r.read(70000), b""))
    assert got == data


def test_port_and_jax_archives():
    data = mixed_corpus(np.random.default_rng(19), 192 * 1024).tobytes()
    for writer in (lambda s: Writer(s, "lz4", device="cpu",
                                    min_frame_size=64 * 1024),
                   lambda s: JWriter(s, "lz4", min_frame_size=64 * 1024)):
        sink = Sink()
        write_all(writer(sink), data, 30 * 1024)
        _reads(sink.value(), data)


def test_stock_liblz4_archives():
    data = mixed_corpus(np.random.default_rng(20), 200 * 1024).tobytes()
    for independent in (False, True):
        log = FrameLog()
        frames = []
        for pos in range(0, len(data), 128 * 1024):
            raw = data[pos: pos + 128 * 1024]
            frames.append(golden.lz4f_compress(
                raw, block_independent=independent))
            log.log_frame(len(frames[-1]), len(raw))
        _reads(b"".join(frames) + log.serialize(), data)
        sizes = [min(128 * 1024, len(data) - p)
                 for p in range(0, len(data), 128 * 1024)]
        host = LZ4Codec(device="cpu")._decompress_frames_host(frames, sizes)
        assert b"".join(host) == data
