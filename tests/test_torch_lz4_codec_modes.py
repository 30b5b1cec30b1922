"""LZ4Codec's other arms against the JAX package's LZ4Codec(parser=
"hash"): independent blocks (each row its own chain) at level -1, and a
payload cap that undershoots (recompact and fetch again) at level 9."""

import numpy as np
import pytest

from libzseek_tpu.runtime.codec import LZ4Codec as JCodec
from libzseek_tpu_torch import LZ4Codec
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_lz4_inputs import codec_frames

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def test_independent_blocks():
    frames = codec_frames(9)
    frames = [frames[0], frames[1], frames[4]]
    kw = dict(level=-1, block_independent=True)
    ref = JCodec(parser="hash", **kw).compress_frames(frames)
    got = LZ4Codec(device="cpu", **kw).compress_frames(frames)
    assert got == ref
    for fr, raw in zip(got, frames):
        assert golden.lz4f_decompress(fr) == raw


def test_cap_undershoot_refetch():
    raw = mixed_corpus(np.random.default_rng(3), 6 << 16).tobytes()
    ref_codec = JCodec(parser="hash", level=9)
    codec = LZ4Codec(device="cpu", level=9)
    ref_codec._cap_hint = codec._cap_hint = 1 << 12
    got = codec.compress_frames([raw])
    assert got == ref_codec.compress_frames([raw])
    assert codec._cap_hint > 1 << 12           # the cap adapted
    assert codec._cap_hint == ref_codec._cap_hint
    assert golden.lz4f_decompress(got[0]) == raw
