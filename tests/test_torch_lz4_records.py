"""The LZ4 decoder's parse phase (ops/lz4_decode.parse_records, the numpy
mirror of csrc/lz4_decode.cu's parse_kernel: one record per sequence,
{literal source, ll, output position, offset}) against the sequence
tables of the port's plain _parse_blocks and of the JAX package's
_parse_blocks (libzseek_tpu/ops/lz4_decode.py:35), on stock liblz4
blocks, damaged copies and a short sequence budget.  Integers:
tolerance none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libzseek_tpu.ops.lz4_decode import _parse_blocks as jax_parse
from libzseek_tpu_torch.ops.lz4_decode import _parse_blocks, parse_records
from libzseek_tpu_torch.testing import golden
from test_torch_lz4_inputs import lz4_raws, pad_frames

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def _compare(comp, clens, unc, max_seqs, linked):
    """Records against both sequence tables: per block the count, each
    field, the derived match length, the output length and the flag."""
    L, M = comp.shape
    lens = np.where(unc, 0, clens).astype(np.int32)
    rec, nrec, blen, bad = parse_records(comp, lens, np.zeros(L, bool),
                                         max_seqs, linked)
    port = [a.numpy() for a in _parse_blocks(
        torch.from_numpy(comp), torch.from_numpy(lens), max_seqs, linked)]
    ref = [np.asarray(a) for a in jax_parse(
        jnp.asarray(comp), jnp.asarray(lens), max_seqs, linked)]
    for tabs in (port, ref):
        lit_src, lit_len, lit_dst, m_off, m_len, m_dst, out_lens, flag = tabs
        np.testing.assert_array_equal(blen, out_lens)
        np.testing.assert_array_equal(bad, flag.astype(np.int32))
        for b in range(L):
            n = int(nrec[b])
            r = rec[b, :n].astype(np.int64)
            nxt = np.append(r[1:, 2], blen[b])
            ml = nxt - r[:, 2] - r[:, 1]
            np.testing.assert_array_equal(r[:, 0], lit_src[b, :n])
            np.testing.assert_array_equal(r[:, 1], lit_len[b, :n])
            np.testing.assert_array_equal(r[:, 2], lit_dst[b, :n])
            np.testing.assert_array_equal(ml, m_len[b, :n])
            np.testing.assert_array_equal(r[:, 2] + r[:, 1], m_dst[b, :n])
            live = ml > 0
            np.testing.assert_array_equal(r[live, 3], m_off[b, :n][live])
            assert not lit_len[b, n:].any() and not m_len[b, n:].any()
    # an uncompressed block is one literal record
    rec_u, n_u, b_u, bad_u = parse_records(comp, clens, unc, max_seqs,
                                           linked)
    for b in np.flatnonzero(unc):
        assert n_u[b] == 1 and b_u[b] == clens[b] and bad_u[b] == 0
        assert rec_u[b, 0].tolist() == [0, int(clens[b]), 0, 0]
    return nrec


def test_records_on_stock_blocks():
    """liblz4's linked and independent frames of text, every mixed
    regime, noise (stored raw) and a tiny frame."""
    raws = lz4_raws(31)
    for independent in (False, True):
        frames = [golden.lz4f_compress(r, block_independent=independent)
                  for r in raws]
        comp, clens, unc, linked = pad_frames(frames)
        B, K, M = comp.shape
        nrec = _compare(comp.reshape(B * K, M), clens.reshape(-1),
                        unc.reshape(-1), min(M // 3 + 2, 2 ** 18 // 4 + 2),
                        linked)
        assert nrec.max() > 300 and unc.any()


def test_records_on_damaged_blocks():
    """Random byte damage, truncation and a budget of 3 and 40
    sequences: the bad flags, the block lengths at the stop and every
    record before it."""
    rng = np.random.default_rng(37)
    text = lz4_raws(31)[0][: 1 << 16]
    good = np.frombuffer(golden.lz4_block_compress(text), np.uint8)
    M = (len(good) + 4095) // 4096 * 4096
    comp = np.zeros((24, M), np.uint8)
    clens = np.full(24, len(good), np.int32)
    for r in range(24):
        comp[r, : len(good)] = good
        if r % 4 == 3:
            clens[r] -= int(rng.integers(1, 40))
        elif r:
            for p in rng.integers(0, len(good), 1 + r % 3).tolist():
                comp[r, p] = int(rng.integers(0, 256))
    unc = np.zeros(24, bool)
    for linked in (True, False):
        for max_seqs in (M // 3 + 2, 3, 40):
            _compare(comp, clens, unc, max_seqs, linked)
