"""The LZ4 decoder's plain version (ops/lz4_decode.py) against the JAX
package's XLA decoder lz4_decode_frames, same padded blocks: out,
out_lens and ok must be equal (tolerance: none), on linked and on
independent frames, with uncompressed blocks among them."""

import numpy as np
import pytest

from libzseek_tpu_torch.runtime.codec import LZ4Codec
from libzseek_tpu_torch.testing import golden
from test_torch_lz4_inputs import (BLOCK, both_decode, codec_frames,
                                   pad_frames)

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def _check(frames, raws):
    comp, clens, unc, linked = pad_frames(frames)
    F = (max(len(r) for r in raws) + BLOCK - 1) // BLOCK * BLOCK
    ref, got = both_decode(comp, clens, unc, F, linked)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    out, out_lens, ok = got
    assert ok.all()
    for r, raw in enumerate(raws):
        assert out[r, : out_lens[r]].tobytes() == raw
    return unc


def test_linked_frames():
    """Stock liblz4's linked frames and the port's (with a raw block)."""
    raws = codec_frames(11)
    raws = [raws[0], raws[1][:BLOCK + 3000], raws[4][:3 * BLOCK]]
    frames = [golden.lz4f_compress(r, block_independent=False)
              for r in raws]
    frames += LZ4Codec(device="cpu").compress_frames(raws)
    unc = _check(frames, raws + raws)
    assert unc.any()


def test_independent_frames():
    raws = codec_frames(12)
    raws = [raws[4][:2 * BLOCK + 77], raws[1][:BLOCK], raws[3]]
    frames = [golden.lz4f_compress(r, block_independent=True) for r in raws]
    frames += LZ4Codec(device="cpu", block_independent=True) \
        .compress_frames(raws)
    unc = _check(frames, raws + raws)
    assert unc.any()
