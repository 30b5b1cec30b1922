"""The numpy mirror of csrc/plan.cu's phases (testing/plan_mirror.py)
against the torch plans (ops/huffman_plan.py plan_blocks, ops/fse_plan.py
plan_seq_tables) on the CPU, so the kernel's algorithm is held to the
plans on a machine with no card: the warp bisection, the per-row moves,
the rank-count fallback, the flat fix, the canonical codes by length
scans and the direct state table.  Rows: the crafted ones of
test_torch_cuda_inputs.plan_edge_rows, each branch shown reached by the
mirror's counts, and random ones.  Where the JAX package imports, its
plan_blocks and plan_seq_tables give the same arrays on the same rows, so
a branch that the staged batches of test_torch_plans.py never reach is
held to the reference too.  Every output is integer and must be equal
(tolerance: none)."""

import numpy as np
import torch

try:
    import jax.numpy as jnp
    from libzseek_tpu.ops import fse_plan as jfpl
    from libzseek_tpu.ops import huffman_plan as jhp
except ImportError:          # a machine with the port alone
    jhp = None

from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import fse_plan as fpl
from libzseek_tpu_torch.ops import huffman_plan as hp
from libzseek_tpu_torch.testing import plan_mirror as pm
from test_torch_cuda_inputs import plan_edge_rows, plan_random_rows

KW = dict(mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
          mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ)


def _torch_plans(b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    return hp.plan_blocks(t["hist"], t["lit_count"], t["n_seq"],
                          t["const"], t["lens"], hist_q=t["hist_q"], **KW) \
        + fpl.plan_seq_tables(t["ll"], t["ml"], t["offv"], t["n_seq"])


def _jax_plans(b):
    j = {k: jnp.asarray(v) for k, v in b.items()}
    out = jhp.plan_blocks(j["hist"], j["lit_count"], j["n_seq"], j["const"],
                          j["lens"], hist_q=j["hist_q"], **KW) \
        + jfpl.plan_seq_tables(j["ll"], j["ml"], j["offv"], j["n_seq"])
    return [np.asarray(a) for a in out]


def _check(b, stats):
    got = pm.plan_all_mirror(**b, **KW, stats=stats)
    ref = _torch_plans(b)
    assert len(got) == len(ref) == 11
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    if jhp is not None:
        for i, (g, r) in enumerate(zip(got, _jax_plans(b))):
            np.testing.assert_array_equal(g, r, err_msg=f"JAX output {i}")
    return got


def test_mirror_edge_rows():
    stats = {}
    got = _check(plan_edge_rows(), stats)
    assert stats["most_moves"] == pm.MOVES, stats
    for branch in ("fallback", "flat", "shrink", "least_k", "rle",
                   "max_log", "pre_log"):
        assert stats.get(branch, 0) > 0, (branch, stats)
    assert set(got[0].tolist()) == {hp.M_SKIP, hp.M_RLEBLOCK, hp.M_NONE,
                                    hp.M_RLE, hp.M_RAW, hp.M_HUF,
                                    hp.M_HUF1}


def test_mirror_random_rows_and_state_tables():
    stats = {}
    for seed in (3, 5, 7):
        _check(plan_random_rows(np.random.default_rng(seed)), stats)
    assert stats.get("max_log", 0) > 0 and stats.get("pre_log", 0) > 0
    # the direct state table against FSE_buildCTable's sort, at each log
    rng = np.random.default_rng(11)
    for lg, ns in ((5, 29), (6, 36), (6, 53), (8, 29), (9, 53)):
        for _ in range(4):
            used = rng.random(ns) < rng.uniform(0.1, 1.0)
            used[rng.integers(ns)] = True
            cut = np.sort(rng.choice(np.arange(1, 1 << lg),
                                     int(used.sum()) - 1, replace=False))
            norm = np.zeros(ns, np.int64)
            norm[used] = np.diff(np.concatenate([[0], cut, [1 << lg]]))
            st, _, _ = fpl._build_ctable(torch.from_numpy(norm)[None], lg)
            np.testing.assert_array_equal(pm.state_table(norm, lg),
                                          st[0].numpy())
