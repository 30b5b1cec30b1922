"""The sort parser's match finding (libzseek_tpu_torch/ops/match.py)
against the JAX package's libzseek_tpu/ops/match.py on the same rows:
every array equal (integer pipelines: tolerance none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import common as JC
from libzseek_tpu.ops import match as JM
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops import match as M
from test_torch_sort_inputs import CTX, ctx_rows, match_rows


def _eq(port, ref, msg=""):
    ref = [np.asarray(r) for r in ref]
    port = [p.numpy() for p in port]
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.shape == b.shape, (msg, i, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} output {i}")


def test_occurrences_and_extensions():
    """u32_window, the nearest previous 4- and 8-byte occurrence (zeros
    and repeats tie in every window), and the forward and backward match
    extensions from random pairs q < p, some near each row's end."""
    X, lens = match_rows()
    xj, lj = jnp.asarray(X), jnp.asarray(lens)
    xt, lt = torch.from_numpy(X), torch.from_numpy(lens)
    np.testing.assert_array_equal(
        C.u32_window(xt).numpy(),
        np.asarray(JC.u32_window(xj)).view(np.uint32).astype(np.int64))
    for window in (4, 8):
        _eq([M.nearest_prev_occurrence(xt, lt, window)],
            [JM.nearest_prev_occurrence(xj, lj, window)], f"window {window}")
    rng = np.random.default_rng(71)
    B, K = X.shape[0], 512
    p = rng.integers(1, X.shape[1], (B, K)).astype(np.int32)
    p[:, :16] = X.shape[1] - rng.integers(1, 40, (B, 16))
    q = (p - rng.integers(1, 300, (B, K))).clip(0).astype(np.int32)
    active = rng.random((B, K)) < 0.8
    min_q = np.array([0, 50, 0, 4000, 10, 0], np.int32)
    pj, qj, aj = jnp.asarray(p), jnp.asarray(q), jnp.asarray(active)
    pt, qt, at = (torch.from_numpy(a) for a in (p, q, active))
    for max_len in (8, 32, 48, 64):
        _eq([M.extend_match_lengths(xt, pt, qt, at, max_len)],
            [JM.extend_match_lengths(xj, pj, qj, aj, max_len)],
            f"max_len {max_len}")
    for min_p, mq in ((0, None), (CTX, min_q)):
        _eq([M.backward_extension(xt, pt, qt, at, 4, min_p=min_p,
                                  min_q=None if mq is None
                                  else torch.from_numpy(mq))],
            [JM.backward_extension(xj, pj, qj, aj, 4, min_p=min_p,
                                   min_q=None if mq is None
                                   else jnp.asarray(mq))],
            f"backward min_p {min_p}")


def test_segment_matches_and_runs():
    """find_segment_matches as zstd calls it (seg_size 4 and 8, the
    8-byte window) and as LZ4 does (dual, the backward extension, both
    windows, unlinked and linked rows with min_ref), then merge_runs over
    the reference's greedy selection of each."""
    X, lens = match_rows()
    Xc, lens_c, min_ref = ctx_rows()
    zstd = dict(min_tail=4, end_margin=0, max_offset=(1 << 17) - 1,
                window=8)
    cases = [(X, lens, None, dict(zstd, seg_size=4, max_len=48)),
             (X, lens, None, dict(zstd, seg_size=8, max_len=32)),
             (X, lens, None, dict(seg_size=4, max_len=48, max_back=4,
                                  dual=True)),
             (X, lens, None, dict(seg_size=8, max_len=48, max_back=4,
                                  dual=True, window=8)),
             (Xc, lens_c, min_ref, dict(seg_size=4, max_len=48, max_back=4,
                                        dual=True, ctx_len=CTX)),
             (Xc, lens_c, min_ref, dict(seg_size=8, max_len=48, max_back=4,
                                        dual=True, ctx_len=CTX))]
    for x, ln, mr, kw in cases:
        ref = JM.find_segment_matches(
            jnp.asarray(x), jnp.asarray(ln),
            min_ref=None if mr is None else jnp.asarray(mr), **kw)
        got = M.find_segment_matches(
            torch.from_numpy(x), torch.from_numpy(ln),
            min_ref=None if mr is None else torch.from_numpy(mr), **kw)
        _eq(got, ref, str(kw))
        sel = JM.greedy_select(*ref, jnp.asarray(ln),
                               min_tail=kw.get("min_tail", 12),
                               c0=kw.get("ctx_len", 0))
        _eq(M.merge_runs(*[torch.from_numpy(np.array(a))
                           for a in sel[:5]]),
            JM.merge_runs(*sel[:5]), f"merge_runs {kw}")
