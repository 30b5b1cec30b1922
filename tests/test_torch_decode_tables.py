"""The read path's host half against the reference: the Huffman peek
tables built with torch ops (build_dtabs, the counterpart of the jitted
_build_dtabs) and the row packing that feeds K4 (the counterpart of
_try_decode_smem's), on the frames of tests/test_torch_decode_inputs.py.
Integer arrays, compared exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import huffman as jhuf
from libzseek_tpu.ops import zstd_decode as jzd
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from test_torch_decode_inputs import capture_reference, own_frames, stock_frames

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def test_build_dtabs_matches_reference():
    """Every table stock libzstd's frames carry, and tables of 2-256
    symbols and code lengths up to 11 bits built by the reference's
    Huffman code from skewed histograms (seed 23).  (The port's own
    frames' tables go through test_rows_match_reference_packing.)"""
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


def test_rows_match_reference_packing(monkeypatch):
    frames, raws = own_frames()
    _, calls = capture_reference(monkeypatch, frames, raws)
    (lp, sq, dtabs, ftabs, meta), _ = calls[0]
    args, out_size, rows = ZD.k4_inputs(frames, [len(r) for r in raws],
                                        torch.device("cpu"))
    B = len(meta)
    assert len(rows["meta"]) == B and out_size == sum(map(len, raws))
    for name, ref, got in (("lp", lp, rows["lp"]), ("sq", sq, rows["sq"])):
        w = min(ref.shape[1], got.shape[1])
        np.testing.assert_array_equal(got[:, :w], ref[:, :w], name)
        assert not got[:, w:].any() and not ref[:, w:].any(), name
    np.testing.assert_array_equal(args[2].numpy(), dtabs)
    np.testing.assert_array_equal(rows["ftabs"], ftabs)
    # meta[1]: the reference predicts every block size, the port knows
    # raw and RLE block sizes only (-1 elsewhere); meta[2], the
    # reference's predicted ring base, is computed inside the port's K4
    cols = [0] + list(range(3, 16))
    np.testing.assert_array_equal(rows["meta"][:, cols], meta[:, cols])
    known = rows["meta"][:, 1] >= 0
    np.testing.assert_array_equal(rows["meta"][known, 1], meta[known, 1])
    starts = np.nonzero(meta[:, 0] & ZD.D.DMODE_FRAME_START)[0]
    np.testing.assert_array_equal(rows["chain"], np.append(starts, B))
    np.testing.assert_array_equal(np.diff(rows["frame_off"]),
                                  [len(r) for r in raws])
