"""greedy_select's plain version (libzseek_tpu_torch/ops/match.py
greedy_select_plain, what the CUDA kernel csrc/greedy_select.cu is held
to) against the JAX package's lax.scan greedy_select: sel, start, the
passed-through end and offset, lit_from and the final cover end equal
(tolerance none)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzseek_tpu.ops import match as JM
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.ops import match as M
from test_torch_sort_inputs import CTX, ctx_rows, greedy_synthetic, match_rows


def _same(args, lengths, **kw):
    ref = JM.greedy_select(*[jnp.asarray(a) for a in args],
                           jnp.asarray(lengths), **kw)
    got = M.greedy_select(*[torch.from_numpy(np.array(a)) for a in args],
                          torch.from_numpy(lengths), **kw)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{kw} output {i}")


def test_plain_matches_jax_on_candidates():
    """The candidates the parsers hand it: zstd's (seg_size 4 and 8,
    min_tail 4 and 12, c0 0) and LZ4's linked rows (c0 = the context
    length, min_tail 12), on rows of length 11, short rows and zeros."""
    X, lens = match_rows()
    for seg_size in (4, 8):
        cand = JM.find_segment_matches(
            jnp.asarray(X), jnp.asarray(lens), seg_size=seg_size,
            max_len=48, min_tail=4, end_margin=0,
            max_offset=(1 << 17) - 1, window=8)
        for min_tail in (4, 12):
            _same(cand, lens, min_tail=min_tail)
    Xc, lens_c, min_ref = ctx_rows()
    for seg_size in (4, 8):
        cand = JM.find_segment_matches(
            jnp.asarray(Xc), jnp.asarray(lens_c), seg_size=seg_size,
            max_len=48, max_back=4, dual=True, ctx_len=CTX,
            min_ref=jnp.asarray(min_ref))
        _same(cand, lens_c, min_tail=12, c0=CTX)


def test_plain_matches_jax_on_synthetic_rows():
    """Random candidates at densities 0.05-0.9, with rows of length 0, 3
    and 11 and rows shorter than c0, for both segment sizes, both tails,
    c0 0 and a context length, and min_match 1 and 4; and the wrapper's
    refusals of malformed inputs."""
    for seed, seg_size, c0 in ((1, 4, 0), (2, 8, 0), (3, 4, 512),
                               (4, 8, 4096)):
        p, off, e, has, lengths = greedy_synthetic(seed, 12, 1024, seg_size,
                                                   c0)
        for min_tail in (4, 12):
            for min_match in (1, 4):
                _same((p, off, e, has), lengths, min_tail=min_tail,
                      min_match=min_match, c0=c0)
    p, off, e, has, lengths = (torch.from_numpy(a) for a in
                               greedy_synthetic(5, 2, 64, 4))
    for bad in ((p.long(), off, e, has, lengths),
                (p, off, e, has.int(), lengths),
                (p, off, e[:, 1:], has, lengths),
                (p, off, e, has, lengths[:1])):
        with pytest.raises(ParameterError):
            M.greedy_select(*bad)
    with pytest.raises(ParameterError):
        M.greedy_select(p, off, e, has, lengths, min_match=-1)
