"""The port's read entry points: open_reader on a path and on a file
object, the no-cache reader (frames decoded onto the device, only the
span copied out), LZ4 archives, and what the port refuses: device="cuda"
without a card, for zstd and LZ4 archives and for the "lz4" codec."""

import io
import struct

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import LZ4Codec, Reader, Writer, open_reader
from libzseek_tpu_torch.errors import FormatError, ParameterError
from libzseek_tpu_torch.runtime.writer import Writer as RuntimeWriter
from libzseek_tpu_torch.testing.corpus import mixed_corpus


def _archive(data, codec="zstd"):
    sink = io.BytesIO()
    w = Writer(sink, codec, device="cpu", min_frame_size=96 * 1024)
    for pos in range(0, len(data), 32 * 1024):
        w.write(data[pos: pos + 32 * 1024])
    w.close()
    return sink.getvalue()


def test_open_reader_entry_points(tmp_path):
    data = mixed_corpus(np.random.default_rng(21), 300 * 1024).tobytes()
    arch = _archive(data)
    path = tmp_path / "a.zst"
    path.write_bytes(arch)
    offs = np.random.default_rng(7).integers(0, len(data) - 8192, 8)
    with open(path, "rb") as f:
        for r in (open_reader(path, device="cpu"),
                  open_reader(f, device="cpu"),
                  open_reader(io.BytesIO(arch), device="cpu", cache_frames=0)):
            assert r.seek_table.num_frames == 4
            assert r.decompressed_size == len(data)
            for off in offs.tolist():
                assert r.pread_full(8192, off) == data[off: off + 8192]
            assert r.pread(10, len(data)) == b""
            st = r.close()
            assert st.frames == 4 and st.decompressed_size == len(data)


def test_refusals(monkeypatch):
    data = mixed_corpus(np.random.default_rng(22), 100 * 1024).tobytes()
    arch = _archive(data)
    lz4 = _archive(data, "lz4")
    r = Reader(lz4, device="cpu")
    assert isinstance(r._codec, LZ4Codec)
    assert r.pread_full(len(data), 0) == data
    # a zstd archive under the LZ4 magic: the codec follows the magic
    fake = struct.pack("<I", 0x184D2204) + arch[4:]
    with pytest.raises(FormatError):
        Reader(fake, device="cpu").pread(10, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for a in (arch, lz4):
        with pytest.raises(ParameterError):
            Reader(a)                # device="cuda" is the default
        with pytest.raises(ParameterError):
            open_reader(io.BytesIO(a), device="cuda")
    with pytest.raises(ParameterError):
        RuntimeWriter(io.BytesIO(), "lz4")
    with pytest.raises(ParameterError):
        Writer(io.BytesIO(), codec="lz4")
    with pytest.raises(ParameterError):
        LZ4Codec()
