"""Whole LZ4 archives: the port's Writer against the JAX package's
Writer given LZ4Codec(parser="hash"), byte for byte (frames and the
checksummed seek table), decoded by stock liblz4; and the port's public
entry points with codec="lz4"."""

import numpy as np
import pytest

from libzseek_tpu.runtime.codec import LZ4Codec as JCodec
from libzseek_tpu.runtime.writer import Writer as JWriter
from libzseek_tpu_torch import LZ4Codec, Writer, open_writer
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
from libzseek_tpu_torch.runtime.writer import Writer as RuntimeWriter
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_lz4_inputs import Sink, write_all

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def test_archive_byte_identical():
    data = mixed_corpus(np.random.default_rng(17), 400 * 1024).tobytes()
    kw = dict(min_frame_size=150 * 1024, batch_frames=2, checksums=True)
    ref, got = Sink(), Sink()
    write_all(JWriter(ref, JCodec(parser="hash"), **kw), data, 50 * 1024)
    write_all(RuntimeWriter(got, LZ4Codec(device="cpu"), **kw), data,
              50 * 1024)
    archive = got.value()
    assert archive == ref.value()
    assert parse_seek_table_bytes(archive).num_frames == 3
    assert golden.lz4f_decompress(archive) == data


def test_entry_points(tmp_path):
    data = mixed_corpus(np.random.default_rng(18), 160 * 1024).tobytes()
    kw = dict(device="cpu", min_frame_size=64 * 1024)
    a = Sink()
    w = Writer(a, "lz4", **kw)
    assert isinstance(w._codec, LZ4Codec) and w._codec.level == 0
    write_all(w, data, 16 * 1024)
    path = tmp_path / "a.lz4"
    write_all(open_writer(path, codec="lz4", level=0, **kw), data, 16 * 1024)
    assert path.read_bytes() == a.value()
    assert golden.lz4f_decompress(a.value()) == data
    b = Sink()
    write_all(Writer(b, codec="lz4", level=9, **kw), data, 16 * 1024)
    assert golden.lz4f_decompress(b.value()) == data
    assert len(b.value()) <= len(a.value())
