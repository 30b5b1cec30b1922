"""The port's codec and Writer against the JAX reference on CPU.

ZstdCodec(device="cpu") runs every kernel's plain version; its frames,
decode hints and whole Writer archives (frames, hints sidecar, seek
table) must be byte-identical to the JAX device chain,
ZstdCodec(parser="linked", entropy="smem") with its Pallas kernels in
interpret mode, and must decode through stock libzstd.

This file keeps exactly five tests: see build_native_runtime in
test_torch_inputs.py for why."""

import io

import numpy as np
import pytest

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu.format import hints as jax_hints
from libzseek_tpu.format.seek_table import parse_seek_table_bytes
from libzseek_tpu.runtime.writer import Writer as JWriter
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch import Writer, ZstdCodec, open_writer
from libzseek_tpu_torch.format import hints as port_hints
from test_torch_inputs import build_native_runtime

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


@pytest.fixture(scope="module", autouse=True)
def native_runtime():
    build_native_runtime()


def _cases():
    rng = np.random.default_rng(0xC0FFEE)
    n = 24 * 1024
    return {
        "text": text_corpus(rng, n).tobytes(),
        "periodic": (rng.integers(0, 256, 337, np.uint8).tobytes()
                     * (n // 337 + 1))[:n],
        "zeros": bytes(n),
        "noise": rng.integers(0, 256, n, np.uint8).tobytes(),
        "tiny": b"abcabcabcabc",
        "one": b"x",
        "mixed": mixed_corpus(rng, 200 * 1024).tobytes(),
    }


CASES = _cases()


def _jax_codec(block=None):
    codec = JCodec(parser="linked", entropy="smem")
    if block:
        codec.block = block
    return codec


def test_frames_byte_identical():
    """Every test_zstd-style case, frames and decode hints."""
    vals = list(CASES.values())
    rf, rh = _jax_codec().compress_frames(vals, return_hints=True)
    gf, gh = ZstdCodec(device="cpu").compress_frames(vals,
                                                     return_hints=True)
    for i, (name, raw) in enumerate(CASES.items()):
        assert gf[i] == rf[i], name
        # the port's hint records are its own classes: compare the bytes
        # of the sidecar each package writes for them
        assert port_hints.serialize([gh[i]]) == jax_hints.serialize([rh[i]])
        assert golden.zstd_decompress(gf[i]) == raw, name


def test_cap_overflow_refetch():
    """An undershooting payload cap (tiny hint, raw-literal-heavy batch)
    takes the recompact-and-refetch path; output is unchanged."""
    raw = np.random.default_rng(3).integers(0, 250, 600_000,
                                            np.uint8).tobytes()
    ref_codec, codec = _jax_codec(), ZstdCodec(device="cpu")
    ref_codec._cap_hint = codec._cap_hint = 1 << 14
    ref = ref_codec.compress_frames([raw])
    got = codec.compress_frames([raw])
    assert got == ref
    assert codec._cap_hint > 1 << 14        # the cap adapted
    assert golden.zstd_decompress(got[0]) == raw


class _Sink:
    def __init__(self):
        self.buf = io.BytesIO()

    def write(self, b):
        self.buf.write(b)


def _write(writer, data, chunk):
    for pos in range(0, len(data), chunk):
        writer.write(data[pos: pos + chunk])
    writer.close()


def test_writer_archive_byte_identical():
    """Whole archives (frames, hints sidecar, checksummed seek table) at
    the main path's 128 KiB blocks and at 16 KiB blocks (linked chains
    of several blocks per frame)."""
    from libzseek_tpu.runtime.writer import Writer as Shared
    for block in (16384, 131072):
        data = mixed_corpus(np.random.default_rng(block),
                            512 * 1024).tobytes()
        kw = dict(min_frame_size=256 * 1024, batch_frames=2, checksums=True)
        ref_sink, sink = _Sink(), _Sink()
        _write(JWriter(ref_sink, _jax_codec(block), **kw), data, 64 * 1024)
        _write(Shared(sink, ZstdCodec(device="cpu", block=block), **kw),
               data, 64 * 1024)
        archive = sink.buf.getvalue()
        assert archive == ref_sink.buf.getvalue(), block
        assert parse_seek_table_bytes(archive).num_frames == 2
        assert golden.zstd_decompress(archive) == data


def test_port_writer_entry_points(tmp_path):
    data = mixed_corpus(np.random.default_rng(8), 96 * 1024).tobytes()
    sink = _Sink()
    _write(Writer(sink, device="cpu", min_frame_size=32 * 1024), data, 8192)
    path = tmp_path / "a.zst"
    _write(open_writer(path, device="cpu", min_frame_size=32 * 1024), data,
           8192)
    archive = path.read_bytes()
    assert archive == sink.buf.getvalue()
    assert parse_seek_table_bytes(archive).num_frames == 3
    assert golden.zstd_decompress(archive) == data


def test_validation_and_unported_parts():
    for block in (0, 1000, 2048, 3 << 14, 1 << 18):
        with pytest.raises(ParameterError):
            ZstdCodec(device="cpu", block=block)
    # every level compresses, with the sort parser too (its segment size
    # and extension length follow the level)
    c = ZstdCodec(level=4, device="cpu", parser="sort")
    assert (c.parser, c.seg_size, c.max_len, c.block) == \
        ("sort", 4, 48, 1 << 16)
    # "lz4" names the port's LZ4Codec at its default level 0; its sort
    # parser is ported too
    from libzseek_tpu_torch import LZ4Codec
    from libzseek_tpu_torch.runtime.writer import Writer as PortWriter
    w = PortWriter(_Sink(), "lz4", device="cpu")
    assert isinstance(w._codec, LZ4Codec) and w._codec.level == 0
    c = LZ4Codec(device="cpu", parser="sort")
    assert (c.parser, c.seg_size) == ("sort", 4)
    with pytest.raises(ParameterError):
        PortWriter(_Sink(), "brotli", device="cpu")
