"""The seek table's batched query and frame count, and the native seek
table (de)serializer, in the port (libzseek_tpu_torch/format/
seek_table.py, libzseek_tpu_torch/native) against the JAX package's
pure-Python format layer: equal indices, bytes and offsets."""

import numpy as np

from libzseek_tpu.format import seek_table as jst
from libzseek_tpu_torch import native
from libzseek_tpu_torch.format import seek_table as st


def _log(mod, sizes, **kw):
    fl = mod.FrameLog(**kw)
    for c, d in sizes:
        fl.log_frame(int(c), int(d))
    return fl


def test_frames_for_offsets_and_entries():
    """tests/test_seek_table.py's table with an empty frame, and 300
    random frames (some empty) queried at 2,000 offsets, past the end
    too; FrameLog.entries counts logged frames."""
    rng = np.random.default_rng(97)
    big = rng.integers(0, 5000, (300, 2))
    big[rng.random(300) < 0.1, 1] = 0
    for sizes in ([(5, 100), (5, 0), (5, 50), (5, 100)], big):
        data = _log(jst, sizes).serialize()
        assert _log(st, sizes).serialize() == data
        ref = jst.parse_seek_table_bytes(data)
        got = st.parse_seek_table_bytes(data)
        total = got.decompressed_size
        offs = np.concatenate([np.arange(0, min(total, 260)),
                               rng.integers(0, total + 100, 2000)])
        np.testing.assert_array_equal(got.frames_for_offsets(offs),
                                      ref.frames_for_offsets(offs))
        if len(sizes) == 4:
            assert list(got.frames_for_offsets(
                [0, 99, 100, 149, 150, 249])) == [0, 0, 2, 2, 3, 3]
    for kw in ({}, {"checksum_flag": True}):
        fl = st.FrameLog(**kw)
        assert fl.entries == 0
        for i in range(7):
            fl.log_frame(i + 1, 2 * i)
        assert fl.entries == len(fl) == _log(jst, [(1, 1)] * 7, **kw).entries


def test_native_seektable_matches_python():
    """zn_seektable_serialize equals the JAX package's FrameLog bytes (no
    checksums); zn_seektable_parse gives the cumulative offsets of those
    bytes and of checksummed tables, and None on a damaged footer, a
    reserved descriptor bit or a short table."""
    rng = np.random.default_rng(101)
    entries = rng.integers(1, 1 << 30, size=(500, 2)).astype(np.uint32)
    blob = native.seektable_serialize(entries)
    assert blob == _log(jst, entries).serialize()
    assert native.seektable_serialize(entries[:0]) == \
        jst.FrameLog().serialize()
    n, cum = native.seektable_parse(blob)
    assert n == 500
    np.testing.assert_array_equal(
        cum, np.concatenate([[[0, 0]], np.cumsum(entries.astype(np.int64),
                                                 0)]))
    fl = jst.FrameLog(checksum_flag=True)
    for c, d in entries[:9]:
        fl.log_frame(int(c), int(d), checksum=int(c) ^ int(d))
    n, cum = native.seektable_parse(fl.serialize())
    ref = jst.parse_seek_table_bytes(fl.serialize())
    assert n == 9
    np.testing.assert_array_equal(cum[:, 0], ref.c_offsets.astype(np.int64))
    np.testing.assert_array_equal(cum[:, 1], ref.d_offsets.astype(np.int64))
    bad = bytearray(blob)
    bad[-5] = 0x40
    for b in (blob[:-1] + b"\x00", bytes(bad), blob[:16],
              blob[:8] + blob[-9:]):
        assert native.seektable_parse(b) is None
