"""The port's Huffman plan (assign_kraft, canonical_from_kraft,
pack_weights/unpack_weights, plan_blocks) and sequence-table plan
(plan_seq_tables) against the JAX reference on CPU, with inputs carried
across by libzseek_tpu_torch/convert.py.  Every output is integer and
must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import fse_plan as jfpl
from libzseek_tpu.ops import huffman_plan as jhp
from libzseek_tpu.ops import pallas_entropy as jpe
from libzseek_tpu_torch.convert import to_torch
from libzseek_tpu_torch.ops import entropy as TE
from libzseek_tpu_torch.ops import fse_plan as tfpl
from libzseek_tpu_torch.ops import huffman_plan as thp
from test_torch_inputs import eq, stage_batch


@pytest.fixture(scope="module")
def batch():
    return stage_batch()


def _kraft_hists():
    rng = np.random.default_rng(3)
    h = np.zeros((10, 256), np.int32)
    h[0] = rng.integers(0, 1000, 256)
    h[1, :128] = 50                          # flat power-of-two alphabet
    h[2] = 7                                 # flat 256 symbols
    h[3, [3, 9]] = [1, 100000]               # two symbols, extreme skew
    h[4, 7] = 500                            # single symbol
    h[5] = (rng.pareto(1.2, 256) * 10).astype(np.int32)
    h[6, :200] = rng.integers(1, 3, 200)     # near-uniform, 200 symbols
    h[7] = (np.arange(256) ** 2) % 97
    h[8, ::3] = rng.integers(1, 30000, 86)
    return h


def _check_assign_kraft_and_canonical():
    h = _kraft_hists()
    rk = jhp.assign_kraft(jnp.asarray(h))
    tk = thp.assign_kraft(torch.from_numpy(h))
    eq(tk, rk)
    for g, r in zip(thp.canonical_from_kraft(tk),
                    jhp.canonical_from_kraft(rk)):
        eq(g, r)
    w = np.array(jhp.canonical_from_kraft(rk)[2])
    pk = thp.pack_weights(torch.from_numpy(w))
    eq(pk, jhp.pack_weights(jnp.asarray(w)))
    np.testing.assert_array_equal(thp.unpack_weights(pk.numpy()),
                                  jhp.unpack_weights(pk.numpy()))


def _check_plan_blocks(batch):
    _, lens, _, _, _, ref = batch
    args = [ref[k] for k in ("hist", "lit_count", "n_seq", "const")]
    kw = dict(mode_huf=jpe.MODE_HUF, mode_huf1=jpe.MODE_HUF1,
              mode_rawlit=jpe.MODE_RAWLIT, mode_seq=jpe.MODE_SEQ)
    r = jhp.plan_blocks(*(jnp.asarray(a) for a in args), jnp.asarray(lens),
                        hist_q=jnp.asarray(ref["hist_q"]), **kw)
    t = thp.plan_blocks(*(to_torch(a, "cpu") for a in args),
                        to_torch(lens, "cpu"),
                        hist_q=to_torch(ref["hist_q"], "cpu"), **kw)
    for g, rr in zip(t, r):
        eq(g, rr)
    modes = set(np.asarray(r[0]).tolist())
    assert {thp.M_HUF, thp.M_RLEBLOCK, thp.M_SKIP} <= modes, modes


def _check_plan_seq_tables(batch):
    _, _, _, _, _, ref = batch
    ll, ml, offv, n = (ref[k] for k in ("ll", "ml", "offv", "n_seq"))
    # an RLE row (one repeated sequence) and a short row
    ll, ml, offv, n = ll.copy(), ml.copy(), offv.copy(), n.copy()
    ll[7, :40], ml[7, :40], offv[7, :40], n[7] = 3, 9, 1, 40
    r = jfpl.plan_seq_tables(*(jnp.asarray(a) for a in (ll, ml, offv, n)))
    t = tfpl.plan_seq_tables(*(to_torch(a, "cpu")
                               for a in (ll, ml, offv, n)))
    for g, rr in zip(t, r):
        eq(g, rr)
    flags = np.bitwise_or.reduce(np.asarray(r[0]))
    for bit in (TE.MODE_LL_FSE, TE.MODE_ML_FSE, TE.MODE_OF_RLE,
                TE.MODE_LL_RLE):
        assert flags & bit, (bit, flags)


def test_plans(batch):
    _check_assign_kraft_and_canonical()
    _check_plan_blocks(batch)
    _check_plan_seq_tables(batch)
