"""Writer archives at level 9 through both parsers: the port's
Writer(sink, "zstd", level=9) (the linked parse with K1's dual, lazy-2
and repcode-probe arms) and Writer(sink, ZstdCodec(level=9,
parser="hash")) (K7 on 64 KiB rows) on the CPU against the JAX package's
Writer with ZstdCodec(level=9, parser="linked", entropy="smem") and
ZstdCodec(level=9, parser="hash"), Pallas kernels in interpret mode: the
whole archive byte-identical, and decoded by stock libzstd."""

import pytest

from libzseek_tpu.testing import golden
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
from test_torch_inputs import level_archives

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


@pytest.mark.parametrize("parser", ["linked", "hash"])
def test_writer_archive_byte_identical_at_level_9(monkeypatch, parser):
    data, ref, got = level_archives(monkeypatch, 9, parser)
    assert got == ref
    assert parse_seek_table_bytes(got).num_frames == 2
    assert golden.zstd_decompress(got) == data
