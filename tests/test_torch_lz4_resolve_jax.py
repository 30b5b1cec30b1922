"""The LZ4 decoder's phases (ops/lz4_decode.parse_records then
resolve_records, the numpy mirrors of csrc/lz4_decode.cu) against the
JAX package's XLA decoder lz4_decode_frames on stock liblz4 frames,
damaged copies, and a reader window whose last frame is short: ok,
out_lens, and out where ok.  Integers: tolerance none."""

import numpy as np
import pytest

import jax.numpy as jnp

from libzseek_tpu.ops.lz4_decode import lz4_decode_frames as jax_decode
from libzseek_tpu_torch.testing import golden
from test_torch_lz4_inputs import BLOCK, lz4_raws, pad_frames, phases

pytestmark = pytest.mark.skipif(not golden.have_lz4(),
                                reason="system liblz4 unavailable")


def _both(comp, clens, unc, F, linked, max_seqs=None):
    ref = jax_decode(jnp.asarray(comp), jnp.asarray(clens),
                     jnp.asarray(unc), F, max_seqs=max_seqs, linked=linked)
    ref = [np.asarray(a) for a in ref]
    got = phases(comp, clens, unc, F, linked, max_seqs)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0][ref[2]], ref[0][ref[2]])
    return got


def test_stock_and_damaged_frames():
    """Linked and independent liblz4 frames and six damaged copies of the
    text frame (bytes of its second block changed, or the block cut)."""
    raws = lz4_raws(41)
    rng = np.random.default_rng(43)
    for independent in (False, True):
        frames = [golden.lz4f_compress(r, block_independent=independent)
                  for r in raws]
        comp, clens, unc, linked = pad_frames(frames)
        n = len(frames)
        comp = np.concatenate([comp, np.repeat(comp[:1], 6, 0)])
        clens = np.concatenate([clens, np.repeat(clens[:1], 6, 0)])
        unc = np.concatenate([unc, np.repeat(unc[:1], 6, 0)])
        for j in range(6):
            if j == 5:
                clens[n + j, 1] -= 17
                continue
            for p in rng.integers(0, int(clens[n + j, 1]), 1 + j).tolist():
                comp[n + j, 1, p] = int(rng.integers(0, 256))
        F = (max(len(r) for r in raws) + BLOCK - 1) // BLOCK * BLOCK
        for max_seqs in (None, 200):
            got = _both(comp, clens, unc, F, linked, max_seqs)
            assert got[2][:n].all() == (max_seqs is None)
            assert not got[2][n:].all()


def test_window_with_a_short_last_frame():
    """Four frames decoded as one reader window, the last of 3,000 bytes:
    every frame equals its input and the bytes past each frame are 0."""
    rng = np.random.default_rng(47)
    raws = lz4_raws(53)
    raws = [raws[1][:3 * BLOCK], raws[0], raws[1][BLOCK: 2 * BLOCK + 11],
            rng.integers(0, 3, 3000, np.uint8).tobytes()]
    frames = [golden.lz4f_compress(r) for r in raws]
    comp, clens, unc, linked = pad_frames(frames)
    F = 3 * BLOCK
    out, out_lens, ok = _both(comp, clens, unc, F, linked)
    assert ok.all()
    for r, raw in enumerate(raws):
        assert out_lens[r] == len(raw)
        assert out[r, : len(raw)].tobytes() == raw
        assert not out[r, len(raw):].any()
