"""The port imports torch and nothing of jax or libzseek_tpu, and asks
for its device explicitly: "cuda" without a card raises.

The test session itself imports jax and the JAX package
(tests/conftest.py), so the import check runs in a fresh interpreter: it
writes a zstd archive (with each parser) and an LZ4 archive (with each
parser) with the port's Writer, the sort archives through the zseek_*
shims, and reads them back with the port's Reader (the zstd one through
the default decoder, whose host delivery takes the transcode route, and
the fused and lane decoders; the LZ4 one through the default) and the
port's own format and testing copies, runs the example CLI
(libzseek_tpu_torch.example) for both codecs, with the scale-out
package (parallel/) imported."""

import os
import subprocess
import sys

import pytest
import torch

from libzseek_tpu_torch.errors import ParameterError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import io, sys
import libzseek_tpu_torch as port
from libzseek_tpu_torch import convert, kernels, native
from libzseek_tpu_torch.ops import (bits, common, decode, entropy,
                                    exec_blocks, fse, fse_plan, hash_parse,
                                    huffman, huffman_plan, lanes, lz4_decode,
                                    lz4_emit, lz4_encode, match,
                                    parse_linked, vector_entropy,
                                    xla_entropy, zstd_decode, zstd_encode)
from libzseek_tpu_torch.parallel import distributed, dryrun, mesh
from libzseek_tpu_torch.runtime import codec
from libzseek_tpu_torch.runtime import io as zio
from libzseek_tpu_torch.testing import dist_worker
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
import numpy as np

data = mixed_corpus(np.random.default_rng(1), 64 * 1024).tobytes()
sink = io.BytesIO()
w = port.Writer(sink, device="cpu", min_frame_size=16 * 1024,
                checksums=True)
for pos in range(0, len(data), 16 * 1024):
    w.write(data[pos: pos + 16 * 1024])
w.close()
archive = sink.getvalue()
assert parse_seek_table_bytes(archive).num_frames == 4
if golden.have_zstd():
    assert golden.zstd_decompress(archive) == data
r = port.Reader(archive, device="cpu", verify_checksums=True)
assert r.pread_full(len(data), 0) == data
assert zstd_decode.routes["transcode_batches"] > 0
r = port.Reader(archive, device="cpu", decoder="fused")
assert r.pread_full(len(data), 0) == data
r = port.Reader(archive, device="cpu", decoder="lanes")
assert r.pread_full(len(data), 0) == data
assert zstd_decode.routes["anchored_frames"] > 0
sink = io.BytesIO()
w = port.Writer(sink, port.ZstdCodec(device="cpu", parser="hash"),
                min_frame_size=16 * 1024)
for pos in range(0, len(data), 16 * 1024):
    w.write(data[pos: pos + 16 * 1024])
w.close()
archive = sink.getvalue()
if golden.have_zstd():
    assert golden.zstd_decompress(archive) == data
r = port.Reader(archive, device="cpu")
assert r.pread_full(len(data), 0) == data
sink = io.BytesIO()
w = port.Writer(sink, "lz4", device="cpu", min_frame_size=16 * 1024,
                checksums=True)
for pos in range(0, len(data), 16 * 1024):
    w.write(data[pos: pos + 16 * 1024])
w.close()
archive = sink.getvalue()
assert parse_seek_table_bytes(archive).num_frames == 4
if golden.have_lz4():
    assert golden.lz4f_decompress(archive) == data
r = port.Reader(archive, device="cpu", verify_checksums=True)
assert isinstance(r._codec, port.LZ4Codec)
assert r.pread_full(len(data), 0) == data
for codec in (port.ZstdCodec(device="cpu", parser="sort"),
              port.LZ4Codec(device="cpu", parser="sort")):
    sink = io.BytesIO()
    w = port.Writer(sink, codec, min_frame_size=16 * 1024)
    for pos in range(0, len(data), 16 * 1024):
        assert port.zseek_write(w, data[pos: pos + 16 * 1024])
    assert port.zseek_writer_close(w).frames == 4
    archive = sink.getvalue()
    if golden.have_zstd() and codec.name == "zstd":
        assert golden.zstd_decompress(archive) == data
    if golden.have_lz4() and codec.name == "lz4":
        assert golden.lz4f_decompress(archive) == data
    r = port.zseek_reader_open(io.BytesIO(archive), device="cpu")
    assert port.zseek_pread(r, 1000, 20000) == data[20000:21000]
    r.prefetch([0, 50000])
    assert port.zseek_reader_stats(r).frames == 4
import os, tempfile
from libzseek_tpu_torch import example
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "sample.bin")
    with open(path, "wb") as f:
        f.write(data)
    for flag in ("--zstd", "--lz4"):
        assert example.main([flag, path, "--device", "cpu"]) == 0
loaded = sorted(m for m in sys.modules
                if m in ("jax", "libzseek_tpu") or
                m.startswith(("jax.", "libzseek_tpu.")))
print("FOREIGN", loaded)
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOREIGN []" in res.stdout, res.stdout


def test_cuda_without_a_card_raises(monkeypatch):
    from libzseek_tpu_torch import LZ4Codec, ZstdCodec
    from libzseek_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ParameterError):
        resolve_device("cuda")
    with pytest.raises(ParameterError):
        ZstdCodec()                        # device="cuda" is the default
    with pytest.raises(ParameterError):
        LZ4Codec()
    with pytest.raises(ParameterError):
        resolve_device("mps")
    assert resolve_device("cpu").type == "cpu"
