"""The read path against the reference on stock libzstd frames: the
Huffman peek tables built with torch ops (build_dtabs, the counterpart
of the jitted _build_dtabs), compared exactly, and K4's plain version fed
the reference's packed rows of those frames (tolerance: none, bytes).
The port's own frames: tests/test_torch_decode_ref.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import huffman as jhuf
from libzseek_tpu.ops import zstd_decode as jzd
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from test_torch_decode_inputs import (capture_reference, check_rows,
                                      section_modes, stock_frames)

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def test_build_dtabs_matches_reference():
    """Every table stock libzstd's frames carry, and tables of 2-256
    symbols and code lengths up to 11 bits built by the reference's
    Huffman code from skewed histograms (seed 23).  (The port's own
    frames' tables go through test_torch_decode_ref.py's
    test_rows_match_reference_packing.)"""
    frames, raws = stock_frames()
    hufreg, fsereg = ZD._HufReg(), ZD._FseReg()
    for d, n in zip(frames, raws):
        ZD._parse_frame_impl(d, hufreg, fsereg, len(n))
    rng = np.random.default_rng(23)
    for n_sym in (2, 3, 17, 64, 200, 256):
        for skew in (0.5, 1.5, 3.0):
            counts = np.zeros(256, np.int64)
            syms = rng.choice(256, n_sym, replace=False)
            counts[syms] = 1 + (rng.pareto(skew, n_sym) * 50).astype(np.int64)
            hufreg.add(jhuf.build_ctable(counts).weights)
    W, TLS = hufreg.weights_arr()
    assert len(W) >= 15 and set(TLS.tolist()) >= {1, 2, 10, 11}, TLS
    got = ZD.build_dtabs(torch.from_numpy(W), torch.from_numpy(TLS))
    ref = np.asarray(jzd._build_dtabs(jnp.asarray(W), jnp.asarray(TLS)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_k4_matches_reference_on_stock_frames(monkeypatch):
    """K4's plain version fed the reference's packed rows of stock
    libzstd frames (as tests/test_torch_decode_ref.py does for the port's
    own frames): ok and equal bytes on every row the reference accepts."""
    frames, raws = stock_frames()
    lits, seqs = section_modes(frames)
    assert {"huf4", "raw"} <= lits and "predefined" in seqs, (lits, seqs)
    res, calls = capture_reference(monkeypatch, frames, raws)
    assert res == raws
    # the reference accepts every frame but the long-window one, whose
    # offsets exceed its 128 KiB ring (tests/test_torch_decode_limits.py)
    assert len(calls) == 1
    meta = calls[0][0][4]
    last = np.nonzero(meta[:, 0] & ZD.D.DMODE_FRAME_START)[0][-1]
    assert check_rows(calls) == last
