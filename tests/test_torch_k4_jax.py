"""K4's phases (ops/decode.decode_mirror, the mirror of csrc/decode.cu:
records with symbolic repcodes, composition, checks, scatter and pointer
doubling) fed the JAX package's own packed rows, held to the Pallas
kernel _decode_kernel in interpret mode (decode_blocks_smem, its fused
route forced as tests/test_decode_smem.py does): on every row the
reference accepts, ok and the bytes of its output row cut to its
advance (tolerance: none)."""

import numpy as np
import pytest

from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.testing import golden
from test_torch_decode_inputs import (capture_reference, own_frames,
                                      port_on_reference_rows,
                                      reference_row_bytes)

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def test_phases_match_the_pallas_kernel(monkeypatch):
    frames, raws = own_frames()
    res, calls = capture_reference(monkeypatch, frames, raws)
    assert res == raws and calls
    rows = 0
    for args, (out_w, stat) in calls:
        assert (stat[:, 1] == 1).all()
        out, pstat, row_off = port_on_reference_rows(args, D.decode_mirror)
        for r in range(len(stat)):
            n = int(stat[r, 0])
            assert pstat[r, 1] == 1 and pstat[r, 0] == n, r
            got = out[row_off[r]: row_off[r] + n].tobytes()
            assert got == reference_row_bytes(out_w, r, n), r
            rows += 1
    assert rows == sum(len(a[4]) for a, _ in calls)
