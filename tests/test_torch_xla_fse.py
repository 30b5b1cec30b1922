"""The XLA entropy arm's sequence half against the reference:
fse_encode_sequences (words, byte sizes, anchor bits, anchor states and
anchor rep1) on a row with more than 4096 sequences, and the
literal/match-length code tables (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu_torch.ops import xla_entropy as XE
from libzseek_tpu_torch.ops import zstd_encode as tze
from test_torch_hash_inputs import N, block_rows, eq, k7_plain


def test_fse_encode_sequences_long_row():
    """The gated 128 KiB rows (log-like: > 4096 sequences with repcodes)
    at the codec's smax bucket, seq_cap and anchor interval; then a
    smaller bucket that cuts the long row, without anchors, as bytes."""
    X, lens = block_rows()
    k7 = k7_plain("blocks")
    seqs = tze._fast_post_nolit(
        torch.from_numpy(X), torch.from_numpy(lens),
        *(torch.from_numpy(a) for a in k7), k7[0].shape[1])
    n = seqs["n_seq"]
    assert int(n.max()) > 4096 and bool((seqs["offv"] <= 3).any())
    smax = 1 << int(n.max() - 1).bit_length()
    cap = (min(N // 2, 11 * smax) + 64 + 127) // 128 * 128
    cut = [seqs[k][:, :smax] for k in ("ll", "ml", "offv")]
    ref = jze.fse_encode_sequences(*(jnp.asarray(a.numpy()) for a in cut),
                                   jnp.asarray(n.numpy()), cap, smax=smax,
                                   anchor_interval=128, return_words=True)
    got = XE.fse_encode_sequences(*cut, n, cap, smax=smax,
                                  anchor_interval=128, return_words=True)
    eq(got[0], ref[0], "words")
    eq(got[1], ref[1], "sizes")
    for g, r, name in zip(got[2], ref[2], ("bits", "states", "rep1")):
        eq(g, r, name)
    small = [a[:, :2048] for a in cut]
    n2 = torch.clamp(n, max=2048)
    ref = jze.fse_encode_sequences(*(jnp.asarray(a.numpy()) for a in small),
                                   jnp.asarray(n2.numpy()), 4096)
    got = XE.fse_encode_sequences(*small, n2, 4096)
    eq(got[0], ref[0], "bytes")
    eq(got[1], ref[1], "sizes")


def test_length_codes():
    """ll_code_dev and ml_code_dev over every length of a block."""
    v = np.arange(0, N + 1, dtype=np.int32)[None, :]
    eq(XE.ll_code_dev(torch.from_numpy(v)), jze.ll_code_dev(jnp.asarray(v)))
    m = v[:, 3:]
    eq(XE.ml_code_dev(torch.from_numpy(m)), jze.ml_code_dev(jnp.asarray(m)))
