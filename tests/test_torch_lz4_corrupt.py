"""Damaged LZ4 input: the plain decoder flags exactly the frames the
JAX package's XLA decoder flags (ok, out_lens, and out where ok); and the
port's native block decoder (zn_lz4_decode, the host route) against
stock liblz4's LZ4_decompress_safe, refusing the damaged blocks."""

import numpy as np
import pytest

from libzseek_tpu_torch import native
from libzseek_tpu_torch.testing import golden
from test_torch_lz4_inputs import BLOCK, both_decode, codec_frames

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def _hand_blocks():
    """(block, note): one good block per case and the damaged kinds."""
    good = golden.lz4_block_compress(b"abcd" * 40 + b"tail-bytes")
    return [
        (good, "good"),
        (good[: len(good) // 2], "truncated literal run"),
        (bytes([0x14]) + b"a" + bytes([0, 0, 0x50]) + b"hello", "offset 0"),
        (bytes([0x14]) + b"a" + bytes([5, 0, 0x50]) + b"hello",
         "offset past the block (and frame) start"),
        (bytes([0xF0, 0xFF, 0xFF]), "literal length runs off the block"),
        (bytes([0x1F]) + b"a" + bytes([1, 0]), "match length runs off"),
    ]


def test_damaged_blocks_flag_alike():
    rng = np.random.default_rng(77)
    text = codec_frames(13)[0][:BLOCK]
    good = golden.lz4_block_compress(text)
    blocks = _hand_blocks()
    for _ in range(24):     # random byte damage to a real block
        b = bytearray(good)
        for p in rng.integers(0, len(b), int(rng.integers(1, 4))).tolist():
            b[p] = int(rng.integers(0, 256))
        blocks.append((bytes(b), "random"))
    M = (max(len(b) for b, _ in blocks) + 4095) // 4096 * 4096
    for linked in (False, True):
        # each damaged block as the second block of a frame whose first
        # block is good: linked frames may reach into it, independent not
        B = len(blocks)
        comp = np.zeros((B, 2, M), np.uint8)
        clens = np.zeros((B, 2), np.int32)
        first = golden.lz4_block_compress(text[:4096])
        for r, (blk, _) in enumerate(blocks):
            comp[r, 0, : len(first)] = np.frombuffer(first, np.uint8)
            clens[r, 0] = len(first)
            comp[r, 1, : len(blk)] = np.frombuffer(blk, np.uint8)
            clens[r, 1] = len(blk)
        unc = np.zeros((B, 2), bool)
        for max_seqs in (None, 3):
            ref, got = both_decode(comp, clens, unc, 2 * BLOCK, linked,
                                   max_seqs=max_seqs)
            np.testing.assert_array_equal(got[2], ref[2])   # ok
            np.testing.assert_array_equal(got[1], ref[1])   # out_lens
            np.testing.assert_array_equal(got[0][ref[2]], ref[0][ref[2]])
            if max_seqs is None:
                assert not ref[2][2] and ref[2][0]
    # a match before the frame start fails a linked frame's first block
    comp = np.zeros((1, 1, 4096), np.uint8)
    bad = blocks[3][0]
    comp[0, 0, : len(bad)] = np.frombuffer(bad, np.uint8)
    ref, got = both_decode(comp, np.array([[len(bad)]], np.int32),
                           np.zeros((1, 1), bool), BLOCK, True)
    assert not ref[2][0] and not got[2][0]


def test_native_block_decoder():
    raws = codec_frames(14)
    for raw in (raws[0][:BLOCK], raws[1][:BLOCK], raws[3],
                raws[4][:BLOCK], raws[4][2 * BLOCK: 3 * BLOCK]):
        comp = golden.lz4_block_compress(raw)
        out = np.zeros(len(raw) + 100, np.uint8)
        n = native.lz4_block_decode(np.frombuffer(comp, np.uint8), out, 100,
                                    100)
        assert n == len(raw)
        assert out[100:].tobytes() == raw == \
            golden.lz4_block_decompress(comp, len(raw))
    for blk, note in _hand_blocks()[1:]:
        out = np.zeros(BLOCK, np.uint8)
        assert native.lz4_block_decode(np.frombuffer(blk, np.uint8), out, 0,
                                       0) == -1, note
    with pytest.raises(ValueError):    # a window start before the buffer
        native.lz4_block_decode(np.frombuffer(comp, np.uint8), out, 0, -1)
