"""The port's XXH32 and LZ4F container code (format/xxhash.py,
format/lz4f.py) against the JAX package's: header build and parse, block
walk and frame assembly, byte for byte and field for field."""

import dataclasses

import numpy as np
import pytest

from libzseek_tpu.errors import FormatError as JFormatError
from libzseek_tpu.format import lz4f as jlz4f
from libzseek_tpu.format.xxhash import xxh32 as jxxh32
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.format import lz4f
from libzseek_tpu_torch.format.xxhash import xxh32


def test_xxh32_matches_reference():
    rng = np.random.default_rng(31)
    for n in (0, 1, 3, 4, 15, 16, 17, 31, 32, 33, 100, 1000, 4099):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        for seed in (0, 1, 0x9E3779B1, 0xFFFFFFFF):
            assert xxh32(data, seed) == jxxh32(data, seed), (n, seed)
    assert xxh32(b"") == 0x02CC5D05     # XXH32's published empty vector


def test_lz4f_headers_blocks_and_frames():
    for cs in (None, 0, 12345, 1 << 40):
        for bsid in (4, 5, 6, 7):
            for ind in (True, False):
                h = lz4f.build_frame_header(cs, bsid, ind)
                assert h == jlz4f.build_frame_header(cs, bsid, ind)
                got = dataclasses.asdict(lz4f.parse_frame_header(b"xy" + h, 2))
                ref = dataclasses.asdict(jlz4f.parse_frame_header(b"xy" + h,
                                                                  2))
                assert got == ref
    rng = np.random.default_rng(32)
    blocks = [(rng.integers(0, 256, n, np.uint8).tobytes(), n % 2 == 1)
              for n in (1, 4096, 65535, 65536, 300)]
    for ind in (True, False):
        fr = lz4f.assemble_frame(blocks, 999, block_independent=ind)
        assert fr == jlz4f.assemble_frame(blocks, 999, block_independent=ind)
        info = lz4f.parse_frame_header(fr)
        got, end = lz4f.parse_blocks(fr, info, info.header_size)
        jinfo = jlz4f.parse_frame_header(fr)
        ref, jend = jlz4f.parse_blocks(fr, jinfo, jinfo.header_size)
        assert end == jend == len(fr)
        assert [dataclasses.astuple(b) for b in got] == \
            [dataclasses.astuple(b) for b in ref]
    # both refuse the same damage
    good = lz4f.build_frame_header(100)
    for bad in (b"\0" + good[1:], good[:4] + bytes([good[4] ^ 0x40])
                + good[5:], good[:-1] + bytes([good[-1] ^ 1]), good[:5]):
        with pytest.raises(JFormatError):
            jlz4f.parse_frame_header(bad)
        with pytest.raises(FormatError):
            lz4f.parse_frame_header(bad)
    trunc = lz4f.assemble_frame(blocks[:2], 10)[:-9]
    info = lz4f.parse_frame_header(trunc)
    with pytest.raises(FormatError):
        lz4f.parse_blocks(trunc, info, info.header_size)
