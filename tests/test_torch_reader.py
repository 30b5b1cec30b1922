"""The read path end to end on the CPU: the port's Reader(device="cpu")
(K4's plain version) on archives written by the port's Writer, by the
JAX Writer (linked parse, smem entropy) and by stock libzstd.  Sequential
read, random pread and the device frame cache return the input bytes,
and every frame equals the JAX package's decode_frames with its fused
route forced (interpret mode)."""

import io

import numpy as np
import pytest
import torch

from libzseek_tpu.ops.zstd_decode import decode_frames as jax_decode_frames
from libzseek_tpu.runtime.writer import Writer as JWriter
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu_torch import Reader, Writer
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_decode_inputs import archive, stock_frames

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _write(writer, data, chunk=64 * 1024):
    for pos in range(0, len(data), chunk):
        writer.write(data[pos: pos + chunk])
    writer.close()


def _check_reader(arch, data, monkeypatch):
    """Sequential read, 24 random 4 KiB preads (seed 7), the device frame
    cache, checksums where the table has them; each frame against JAX."""
    r = Reader(arch, device="cpu", verify_checksums=True)
    got = bytearray()
    while chunk := r.read(50_000):
        got += chunk
    assert bytes(got) == data
    offs = np.random.default_rng(7).integers(0, len(data) - 4096, 24)
    for off in offs.tolist():
        assert r.pread_full(4096, off) == data[off: off + 4096], off
    rd = Reader(arch, device="cpu", device_cache=True, cache_frames=4)
    for off in offs[:16].tolist():
        assert rd.pread_full(4096, off) == data[off: off + 4096], off
    cached = list(rd._cache._map.values())
    assert cached and all(isinstance(c, torch.Tensor) for c in cached)
    t = r.seek_table
    frames = [arch[t.frame_c_offset(i): t.frame_c_offset(i + 1)]
              for i in range(t.num_frames)]
    sizes = [t.frame_d_size(i) for i in range(t.num_frames)]
    monkeypatch.setenv("ZN_DECODE_SMEM", "force")
    monkeypatch.setenv("ZN_DECODE_TRANSCODE", "off")
    ref = jax_decode_frames(frames, sizes)
    assert r._codec.decompress_frames(frames, sizes) == ref
    r.close()
    rd.close()


def test_reader_on_port_archive(monkeypatch):
    """Frames of 192 KiB (a 128 KiB and a 64 KiB block) and a short last
    one, with per-frame checksums."""
    data = mixed_corpus(np.random.default_rng(12), 600 * 1024).tobytes()
    sink = io.BytesIO()
    _write(Writer(sink, device="cpu", min_frame_size=160 * 1024,
                  checksums=True), data)
    arch = sink.getvalue()
    assert golden.zstd_decompress(arch) == data
    _check_reader(arch, data, monkeypatch)


def test_reader_on_jax_and_stock_archives(monkeypatch):
    data = mixed_corpus(np.random.default_rng(13), 320 * 1024).tobytes()
    sink = io.BytesIO()
    _write(JWriter(sink, JCodec(parser="linked", entropy="smem"),
                   min_frame_size=128 * 1024, checksums=True), data)
    _check_reader(sink.getvalue(), data, monkeypatch)
    frames, raws = stock_frames()
    _check_reader(archive(frames, raws), b"".join(raws), monkeypatch)
