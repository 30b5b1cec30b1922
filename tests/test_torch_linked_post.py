"""The port's _linked_post, _rep1_rewrite, ldm_literal_stats,
apply_ldm_override and compact_payload against the JAX reference on
CPU, with inputs carried across by libzseek_tpu_torch/convert.py.  Every
output is integer and must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu_torch.convert import seqs_to_torch, to_torch
from libzseek_tpu_torch.ops import zstd_encode as tze
from test_torch_inputs import N_STAGE as N
from test_torch_inputs import eq, stage_batch


@pytest.fixture(scope="module")
def batch():
    return stage_batch()


def _check_linked_post(batch):
    X, lens, _, _, k1, ref = batch
    got = tze._linked_post(torch.from_numpy(X[1:]), torch.from_numpy(lens),
                           *(torch.from_numpy(a) for a in k1[:5]),
                           k1[0].shape[1], torch.from_numpy(k1[5]))
    assert set(got) == set(ref)
    for k in ref:
        eq(got[k], ref[k], k)
    assert (ref["offv"][ref["offv"] > 0] <= 3).any(), "no repcodes"


def _check_rep1_rewrite_random():
    rng = np.random.default_rng(9)
    B, S = 6, 400
    offv = rng.choice([4, 5, 9, 40, 41, 100], (B, S)).astype(np.int32)
    ll = rng.integers(0, 3, (B, S)).astype(np.int32)
    n = np.array([0, 1, 50, 399, 400, 17])
    valid = np.arange(S)[None, :] < n[:, None]
    offv = np.where(valid, offv, 0)
    ref = jze._rep1_rewrite(jnp.asarray(offv), jnp.asarray(ll),
                            jnp.asarray(valid))
    got = tze._rep1_rewrite(torch.from_numpy(offv), torch.from_numpy(ll),
                            torch.from_numpy(valid))
    eq(got, ref)


def _check_ldm_override_and_stats(batch):
    X, lens, _, _, _, ref = batch
    blocks = [X[i + 1, : lens[i]] for i in range(8)]
    spans = np.zeros((8, 3), np.int64)
    spans[1] = (70000, 0, N)            # whole-block hit
    spans[4] = (200000, 100, N - 37)    # head and tail literals
    spans[6] = (131072, 33, 4000)
    r_sp, r_hist, _ = jze.ldm_literal_stats(spans[:7], blocks[:7], 8, N,
                                            need_plane=False)
    t_sp, t_hist = tze.ldm_literal_stats(spans[:7], blocks[:7], 8)
    np.testing.assert_array_equal(t_sp, r_sp)
    np.testing.assert_array_equal(t_hist, r_hist)
    rseqs = {k: jnp.asarray(v) for k, v in ref.items()}
    r = jze.apply_ldm_override(rseqs, r_sp, lens, r_hist)
    t = tze.apply_ldm_override(seqs_to_torch(ref, "cpu"), t_sp, lens,
                               t_hist)
    for k in r:
        eq(t[k], r[k], k)


def _check_compact_payload(cap_words):
    rng = np.random.default_rng(cap_words)
    B, LW, SW = 8, 1024, 800
    lw = rng.integers(0, 2 ** 32, (B, LW), dtype=np.uint64).astype(np.uint32)
    sw = rng.integers(0, 2 ** 32, (B, SW), dtype=np.uint64).astype(np.uint32)
    lb = rng.integers(0, 4 * LW, B).astype(np.int32)
    sb = rng.integers(0, 4 * SW, B).astype(np.int32)
    lb[2] = 0
    sb[5] = 0
    ref = jze.compact_payload(jnp.asarray(lw), jnp.asarray(lb),
                              jnp.asarray(sw), jnp.asarray(sb), cap_words)
    got = tze.compact_payload(to_torch(lw, "cpu"), to_torch(lb, "cpu"),
                              to_torch(sw, "cpu"), to_torch(sb, "cpu"),
                              cap_words)
    for g, r in zip(got, ref):
        eq(g, r)


def test_linked_post_and_repcodes(batch):
    _check_linked_post(batch)
    _check_rep1_rewrite_random()


def test_ldm_override_and_compaction(batch):
    _check_ldm_override_and_stats(batch)
    for cap_words in (1 << 12, 1 << 15):
        _check_compact_payload(cap_words)
