"""The port's LZ4Codec(device="cpu") (runtime/codec.py, K5's plain
version) against the JAX package's LZ4Codec(parser="hash"), whose fused
arm runs the Pallas kernel in interpret mode: LZ4F frames must be
byte-identical, decode through stock liblz4 and through the port's own
routes: the native host route (host delivery) and the decoder's plain
version (to_device=True)."""

import pytest

from libzseek_tpu.runtime.codec import LZ4Codec as JCodec
from libzseek_tpu_torch import LZ4Codec
from libzseek_tpu_torch.testing import golden
from test_torch_lz4_inputs import codec_frames

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def _same(frames, **kw):
    ref = JCodec(parser="hash", **kw).compress_frames(frames)
    codec = LZ4Codec(device="cpu", **kw)
    got = codec.compress_frames(frames)
    assert got == ref
    for fr, raw in zip(got, frames):
        assert golden.lz4f_decompress(fr) == raw
    sizes = [len(f) for f in frames]
    assert codec.decompress_frames(got, sizes) == frames
    dev = codec.decompress_frames(got, sizes, to_device=True)
    assert [t.numpy().tobytes() for t in dev] == frames
    return codec


def test_frames_byte_identical():
    """Level 0: a short last block, an incompressible block stored raw,
    an empty and a tiny frame, every mixed regime."""
    _same(codec_frames(7))


def test_frame_split_across_batches():
    """Three-block batches at level 3 (the lazy arm): frames continue
    across batches, so a batch's row 0 is the previous block of the
    frame its first row continues (the seed)."""
    frames = codec_frames(8)
    _same([frames[0], frames[4]], level=3, max_batch_blocks=3)
