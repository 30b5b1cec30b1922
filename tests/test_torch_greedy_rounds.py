"""greedy_select as csrc/greedy_select.cu walks it (warp rounds, each row
split into chunks over a block's warps, the true entries resolved after;
numpy mirror libzseek_tpu_torch/testing/greedy_mirror.py) against the
port's plain version (ops/match.py greedy_select_plain) and the JAX
package's lax.scan greedy_select: sel, start, lit_from and the final
cover end equal (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import match as JM
from libzseek_tpu_torch.ops import match as M
from libzseek_tpu_torch.testing.greedy_mirror import greedy_rounds
from test_torch_sort_inputs import CTX, ctx_rows, greedy_synthetic, match_rows


def _three(p, e, has, lengths, **kw):
    """The mirror against plain and the JAX function; its stats."""
    stats = {}
    mir = greedy_rounds(p, e, has, lengths, kw.get("min_tail", 12),
                        kw.get("min_match", 4), kw.get("c0", 0), stats)
    t = lambda a: torch.from_numpy(np.array(a))
    got = M.greedy_select(t(p), t(np.zeros_like(p)), t(e), t(has),
                          t(lengths), **kw)
    ref = JM.greedy_select(*[jnp.asarray(a) for a in
                             (p, np.zeros_like(p), e, has, lengths)], **kw)
    for m, i in zip(mir, (0, 1, 4, 5)):
        np.testing.assert_array_equal(m, got[i].numpy(), err_msg=f"{i}")
        np.testing.assert_array_equal(m, np.asarray(ref[i]), err_msg=f"{i}")
    return stats


def test_rounds_on_candidates():
    """The parsers' candidates on 8 KiB rows (mixed, text, log lines,
    zeros and period-37 repeats, whose cover end jumps past many rounds
    and whose every segment is selected, and noise): zstd's (seg_size 4
    and 8, min_tail 4 and 12) and LZ4's linked rows (c0 = the context
    length, min_tail 12): 8 chunks a row at seg_size 4."""
    stats = []
    X, lens = match_rows()
    for seg_size in (4, 8):
        p, _, e, has = (np.asarray(a) for a in JM.find_segment_matches(
            jnp.asarray(X), jnp.asarray(lens), seg_size=seg_size,
            max_len=48, min_tail=4, end_margin=0,
            max_offset=(1 << 17) - 1, window=8))
        for min_tail in (4, 12):
            stats.append(_three(p, e, has, lens, min_tail=min_tail))
    Xc, lens_c, min_ref = ctx_rows()
    p, _, e, has = (np.asarray(a) for a in JM.find_segment_matches(
        jnp.asarray(Xc), jnp.asarray(lens_c), seg_size=4, max_len=48,
        max_back=4, dual=True, ctx_len=CTX, min_ref=jnp.asarray(min_ref)))
    stats.append(_three(p, e, has, lens_c, min_tail=12, c0=CTX))
    for st in (stats[0], stats[-1]):
        assert st["chunks"] == 8 * len(lens) and st["filled"] > 0
        # a run of selections takes one step (the zeros and repeats rows)
        assert st["selections"] > 3000 and \
            st["steps"] < st["selections"] / 4


def test_rounds_edges():
    """All-candidate rows (each segment selected) and rows without a
    candidate; the min_tail edge (a start exactly at lengths - min_tail);
    padding rows with negative lengths (LZ4's, c0 = the context); random
    rows at densities 0.05-0.9 whose guessed chunk entries fail the test
    (walked again); segment counts not a multiple of 32; min_match 0."""
    nseg = 3001
    base = np.arange(nseg, dtype=np.int32)[None, :] * 4
    p = np.repeat(base, 6, 0)
    e = p + 48
    has = np.ones((6, nseg), bool)
    has[1] = False
    lengths = np.array([4 * nseg, 4 * nseg, 4 * 1000 + 12, -5, -70000,
                        4 * nseg], np.int32)
    e[2, 1000] = 4 * 1000 + 4          # starts at the tail's limit
    for kw in (dict(min_tail=12), dict(min_tail=12, c0=4096),
               dict(min_tail=4, min_match=0)):
        st = _three(p, e, has, lengths, **kw)
        assert st["selections"] > 3000 and st["max_chunk_steps"] <= 16
    rewalks = 0
    for seed, seg_size, c0 in ((1, 4, 0), (4, 8, 4096)):
        p, _, e, has, lengths = greedy_synthetic(seed, 8, 3000, seg_size,
                                                 c0)
        for min_match in (1, 4):
            rewalks += _three(p, e, has, lengths, min_tail=12,
                              min_match=min_match, c0=c0)["rewalks"]
    assert rewalks > 0
