"""A Writer archive through ZstdCodec(parser="hash") against the JAX
package's Writer with its ZstdCodec(parser="hash"): the whole archive
(frames, decode-hints sidecar, checksummed seek table) byte-identical,
decoded by stock libzstd and read back by the port's Reader."""

import io

import numpy as np
import pytest

from libzseek_tpu.runtime.writer import Writer as JWriter
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus
from libzseek_tpu_torch import Reader, Writer, ZstdCodec
from libzseek_tpu_torch.format import hints as port_hints
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
from test_torch_hash_inputs import N, interpret_k7, log_like
from test_torch_inputs import build_native_runtime

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _write(writer, data, chunk):
    for pos in range(0, len(data), chunk):
        writer.write(data[pos: pos + chunk])
    writer.close()


def test_hash_writer_archive(monkeypatch):
    """Two mixed frames (the K2 arm) and a log-like frame (the XLA arm)
    in one archive, written in 64 KiB pieces, two frames per batch."""
    build_native_runtime()
    interpret_k7(monkeypatch)
    data = mixed_corpus(np.random.default_rng(73), 2 * N).tobytes() + \
        log_like(79, N)
    kw = dict(min_frame_size=N, batch_frames=2, checksums=True)
    ref, got = io.BytesIO(), io.BytesIO()
    _write(JWriter(ref, codec=JCodec(parser="hash"), **kw), data, 1 << 16)
    _write(Writer(got, ZstdCodec(device="cpu", parser="hash"), **kw), data,
           1 << 16)
    archive = got.getvalue()
    assert archive == ref.getvalue()
    assert parse_seek_table_bytes(archive).num_frames == 3
    assert port_hints.HINTS_MAGIC.to_bytes(4, "little") in archive
    assert golden.zstd_decompress(archive) == data
    with Reader(archive, device="cpu", verify_checksums=True) as r:
        assert r.pread_full(len(data), 0) == data
        assert r.pread_full(5000, 2 * N - 2500) == data[2 * N - 2500:
                                                         2 * N + 2500]
