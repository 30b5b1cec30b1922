"""The block size follows the level as the reference's ZstdCodec does
(libzseek_tpu/runtime/zstd_codec.py:140-148): 64 KiB from level 4 up,
128 KiB below, for both parsers; an explicit block (the reference's
ZN_BLOCK) wins at every level and is still validated.  And the public
entry points write at a level >= 4 with no other change."""

import io

import numpy as np
import pytest

from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus
from libzseek_tpu_torch import Writer, ZstdCodec, open_writer
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes


def test_block_follows_level():
    for level, block in ((-1, 131072), (3, 131072), (4, 65536),
                         (9, 65536), (16, 65536), (22, 65536)):
        for parser in ("linked", "hash"):
            codec = ZstdCodec(level=level, device="cpu", parser=parser)
            assert codec.block == block, (level, parser)
    for level in (3, 4, 16):
        for block in (4096, 16384, 65536, 131072):
            assert ZstdCodec(level=level, device="cpu",
                             block=block).block == block
        for block in (0, 1000, 2048, 3 << 14, 1 << 18):
            with pytest.raises(ParameterError):
                ZstdCodec(level=level, device="cpu", block=block)


@pytest.mark.skipif(not golden.have_zstd(),
                    reason="system libzstd unavailable")
def test_entry_points_write_at_level_9(tmp_path):
    data = mixed_corpus(np.random.default_rng(9), 160 * 1024).tobytes()
    kw = dict(device="cpu", min_frame_size=96 * 1024)
    sink = io.BytesIO()
    w = Writer(sink, "zstd", level=9, **kw)
    assert w._codec.level == 9 and w._codec.block == 65536
    for pos in range(0, len(data), 8192):
        w.write(data[pos: pos + 8192])
    w.close()
    path = tmp_path / "a.zst"
    w = open_writer(path, level=9, **kw)
    for pos in range(0, len(data), 8192):
        w.write(data[pos: pos + 8192])
    w.close()
    archive = path.read_bytes()
    assert archive == sink.getvalue()
    assert parse_seek_table_bytes(archive).num_frames == 2
    assert golden.zstd_decompress(archive) == data
