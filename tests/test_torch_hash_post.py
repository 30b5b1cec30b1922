"""The hash parse's gate and recompaction (_fast_post_nolit, _fast_post)
against the reference's XLA versions, field by field, on K7's outputs for
the 128 KiB rows and the 16 KiB rows (tolerance: none)."""

import jax.numpy as jnp
import torch

from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu_torch.ops import zstd_encode as tze
from test_torch_hash_inputs import block_rows, eq, k7_plain, small_rows


def _both(name, which):
    X, lens = block_rows() if which == "blocks" else small_rows()
    k7 = k7_plain(which)
    cap = k7[0].shape[1]
    ref = getattr(jze, name)(jnp.asarray(X), jnp.asarray(lens),
                             *(jnp.asarray(a) for a in k7), cap)
    got = getattr(tze, name)(torch.from_numpy(X), torch.from_numpy(lens),
                             *(torch.from_numpy(a) for a in k7), cap)
    assert sorted(got) == sorted(ref)
    for key in ref:
        eq(got[key], ref[key], key)
    return got


def test_fast_post_nolit_fields():
    """Every field; the log-like row keeps more than 4096 sequences (the
    XLA arm's trigger), the mixed row far fewer."""
    got = _both("_fast_post_nolit", "blocks")
    n = got["n_seq"].numpy()
    assert n[0] > 4096 and 0 < n[1] < 4096
    _both("_fast_post_nolit", "small")


def test_fast_post_fields_with_literal_plane():
    got = _both("_fast_post", "blocks")
    lc = got["lit_count"].numpy()
    assert (got["literals"].numpy()[:, lc.max():] == 0).all()
    _both("_fast_post", "small")
