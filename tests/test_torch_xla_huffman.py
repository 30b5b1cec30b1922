"""The XLA entropy arm's literal half and the bit packers against the
reference: huffman_encode_literals (words, stream sizes, decode anchors)
and ops/bits.py (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import bits as JB
from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu_torch import native
from libzseek_tpu_torch.ops import bits as TB
from libzseek_tpu_torch.ops import xla_entropy as XE
from libzseek_tpu_torch.ops import zstd_encode as tze
from test_torch_hash_inputs import N, block_rows, eq, k7_plain


def test_huffman_encode_literals():
    """The literal planes of the gated 128 KiB rows with their own
    Huffman codes, a row masked to no literals (as the codec masks
    non-Huffman rows), at the codec's width and anchor interval."""
    X, lens = block_rows()
    k7 = k7_plain("blocks")
    seqs = tze._fast_post(torch.from_numpy(X), torch.from_numpy(lens),
                          *(torch.from_numpy(a) for a in k7), k7[0].shape[1])
    lc = seqs["lit_count"].numpy().copy()
    lengths, codes, _, _ = native.huf_build_batch(
        seqs["hist"].numpy().astype(np.uint32))
    lc[1] = 0
    lcap = min(N, 1 << int(lc.max() - 1).bit_length())
    out_bytes = (lcap + 64 + 127) // 128 * 128
    lits = seqs["literals"][:, :lcap]
    for words in (True, False):
        ref = jze.huffman_encode_literals(
            jnp.asarray(lits.numpy()), jnp.asarray(lc), jnp.asarray(codes),
            jnp.asarray(lengths), out_bytes, anchor_interval=512,
            return_words=words)
        got = XE.huffman_encode_literals(
            lits, torch.from_numpy(lc), torch.from_numpy(codes),
            torch.from_numpy(lengths), out_bytes, anchor_interval=512,
            return_words=words)
        for g, r, name in zip(got, ref, ("streams", "sizes", "anchors")):
            eq(g, r, name)
    s, sz = XE.huffman_encode_literals(lits, torch.from_numpy(lc),
                                       torch.from_numpy(codes),
                                       torch.from_numpy(lengths), out_bytes)
    eq(sz, ref[1])


def test_bit_packers():
    """pack_bits (0-32 bit emissions at running offsets), pack_bits_at
    past the buffer's end, close_stream_bits and words_to_bytes."""
    rng = np.random.default_rng(37)
    vals = rng.integers(0, 1 << 32, (5, 700), dtype=np.uint64) \
        .astype(np.uint32)
    nbits = rng.integers(0, 33, (5, 700)).astype(np.int32)
    nbits[1] = 0
    W = 480
    jw, jt = JB.pack_bits(jnp.asarray(vals), jnp.asarray(nbits), W)
    tw, tt = TB.pack_bits(torch.from_numpy(vals.view(np.int32)),
                          torch.from_numpy(nbits), W)
    eq(tw, jw)
    eq(tt, jt)
    pos = np.cumsum(nbits, 1) - nbits + 7
    jw = JB.pack_bits_at(jnp.asarray(vals), jnp.asarray(nbits),
                         jnp.asarray(pos), W)
    tw = TB.pack_bits_at(torch.from_numpy(vals.view(np.int32)),
                         torch.from_numpy(nbits), torch.from_numpy(pos), W)
    eq(tw, jw)
    eq(TB.close_stream_bits(tt), JB.close_stream_bits(jt))
    eq(TB.words_to_bytes(tw, 4 * W - 3), JB.words_to_bytes(jw, 4 * W - 3))
