"""Writer archives at levels 4 and 16 (64 KiB blocks, K1's dual, lazy and
repcode-probe arms, K3 off): the port's Writer(sink, "zstd", level=L) on
the CPU against the JAX package's Writer with ZstdCodec(level=L,
parser="linked", entropy="smem") (its Pallas kernels in interpret mode):
the whole archive (frames, decode-hints sidecar, checksummed seek table)
byte-identical, and decoded by stock libzstd.  Level 9 and the hash
parser: test_torch_levels_archive9.py."""

import pytest

from libzseek_tpu.testing import golden
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
from test_torch_inputs import level_archives

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


@pytest.mark.parametrize("level", [4, 16])
def test_writer_archive_byte_identical_at_level(monkeypatch, level):
    data, ref, got = level_archives(monkeypatch, level)
    assert got == ref
    assert parse_seek_table_bytes(got).num_frames == 2
    assert golden.zstd_decompress(got) == data
