"""The LZ4 sort parser: lz4_encode_blocks (libzseek_tpu_torch/ops/
lz4_encode.py) against the JAX package's (out, out_lens), and
LZ4Codec(parser="sort", device="cpu") archives against the JAX
LZ4Codec(parser="sort")'s, byte-identical at levels 0 and -1 (segment
sizes 4 and 8), linked and block_independent, and decoded by stock
liblz4 (tolerance none)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzseek_tpu.ops import lz4_encode as jle
from libzseek_tpu.runtime.codec import LZ4Codec as JCodec
from libzseek_tpu.runtime.writer import Writer as JWriter
from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch import LZ4Codec, Writer
from libzseek_tpu_torch.ops import lz4_encode as le
from libzseek_tpu_torch.testing.corpus import log_corpus

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")

BLOCK = 1 << 16


def _rows(ctx: int):
    """Four rows of ctx + 64 KiB, seed 83: mixed, text (its window starts
    100 bytes in), zeros and period-337 repeats (a frame's first block:
    no window); lengths cut by 0-3000 bytes."""
    rng = np.random.default_rng(83)
    srcs = [mixed_corpus(rng, 2 * BLOCK), text_corpus(rng, 2 * BLOCK),
            np.zeros(2 * BLOCK, np.uint8),
            np.tile(rng.integers(0, 256, 337, np.uint8),
                    2 * BLOCK // 337 + 1)[: 2 * BLOCK]]
    X = np.zeros((4, ctx + BLOCK), np.uint8)
    lens = np.zeros(4, np.int32)
    min_ref = np.zeros(4, np.int32)
    for i, s in enumerate(srcs):
        n = BLOCK - 1000 * i
        X[i, ctx: ctx + n] = s[BLOCK: BLOCK + n]
        lens[i] = ctx + n
        if ctx:
            X[i, :ctx] = s[BLOCK - ctx: BLOCK]
            min_ref[i] = [0, 100, 0, ctx][i]
    return X, lens, min_ref


def test_encode_blocks_match_jax():
    for ctx in (0, BLOCK):
        X, lens, min_ref = _rows(ctx)
        for seg_size in (4, 8):
            ref = jle.lz4_encode_blocks(jnp.asarray(X), jnp.asarray(lens),
                                        seg_size=seg_size, ctx_len=ctx,
                                        min_ref=jnp.asarray(min_ref))
            got = le.lz4_encode_blocks(torch.from_numpy(X),
                                       torch.from_numpy(lens),
                                       seg_size=seg_size, ctx_len=ctx,
                                       min_ref=torch.from_numpy(min_ref))
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{ctx} {seg_size}")


def test_codec_archives_match_jax():
    """Frames of 2 blocks (mixed), 70 KB of log lines, a small frame and
    an empty one through both codecs; then a whole archive through the
    two Writers at level 0."""
    rng = np.random.default_rng(89)
    frames = [mixed_corpus(rng, 2 * BLOCK).tobytes(),
              log_corpus(rng, 70000).tobytes(), b"xyz" * 100, b""]
    for level in (0, -1):
        for independent in (False, True):
            kw = dict(level=level, parser="sort",
                      block_independent=independent)
            ref = JCodec(**kw).compress_frames(frames)
            got = LZ4Codec(device="cpu", **kw).compress_frames(frames)
            for i, raw in enumerate(frames):
                assert got[i] == ref[i], (level, independent, i)
                assert golden.lz4f_decompress(got[i]) == raw
    data = b"".join(frames[:2])
    ref, got = io.BytesIO(), io.BytesIO()
    with JWriter(ref, JCodec(parser="sort"), min_frame_size=BLOCK) as w:
        w.write(data)
    with Writer(got, LZ4Codec(device="cpu", parser="sort"),
                min_frame_size=BLOCK) as w:
        w.write(data)
    assert got.getvalue() == ref.getvalue()
    assert golden.lz4f_decompress(got.getvalue()) == data
