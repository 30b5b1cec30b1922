"""K4's plain version and the row packing that feeds it, against the
reference on its own packed rows.

The JAX package's decode_frames runs with its fused route forced
(pallas_decode.decode_blocks_smem in interpret mode) on the port's own
frames, once for the module; every array its _try_decode_smem passes to
the kernel is recorded.  Those rows, fed unchanged to the port's
ops/decode.decode_blocks on the CPU, give ok 1 on every row the
reference accepts and bytes equal to the reference's output row cut to
its advance (tolerance: none, bytes).  The port's own packing
(zstd_decode.k4_inputs, the counterpart of _try_decode_smem's) of the
same frames gives the same integer arrays.  The frames cover 4- and
1-stream Huffman, raw and RLE literals, predefined, RLE and compressed
FSE tables and a 3-block frame whose repcodes carry across blocks.
Stock libzstd frames: tests/test_torch_decode_tables.py."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from test_torch_decode_inputs import (capture_reference, check_rows,
                                      own_frames, section_modes)

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


@pytest.fixture(scope="module")
def own_capture():
    """(frames, raws, the reference's results, its recorded calls) on the
    port's own frames."""
    frames, raws = own_frames()
    with pytest.MonkeyPatch.context() as mp:
        res, calls = capture_reference(mp, frames, raws)
    return frames, raws, res, calls


def test_plain_k4_matches_reference_on_own_frames(own_capture):
    frames, raws, res, calls = own_capture
    lits, seqs = section_modes(frames)
    assert {"huf4", "huf1", "raw", "rle"} <= lits, lits
    assert {"rle", "compressed"} <= seqs, seqs
    assert res == raws
    assert calls and all((s[:, 1] == 1).all() for _, (_, s) in calls)
    assert check_rows(calls) == sum(len(a[4]) for a, _ in calls)


def test_rows_match_reference_packing(own_capture):
    frames, raws, _, calls = own_capture
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
