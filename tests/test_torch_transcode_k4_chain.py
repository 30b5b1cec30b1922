"""K4's transcode arm (plain) against the reference kernel (interpret) on
multi-block frames, whose repcodes carry from block to block along a
chain: 320 KiB of repeated text with scattered edits in three 128 KiB
blocks, by the JAX codec and by stock libzstd at levels 3 and 19, with
the host literals on and off (every block's literals fit the reference's
device-literal window, so its route takes them all).  Stat, tokens and
literal words equal (tolerance: none)."""

import numpy as np
import pytest

from libzseek_tpu_torch.ops import decode as D
from test_torch_transcode_inputs import (capture_transcode, chain_frames,
                                         check_rows)


@pytest.mark.parametrize("host_literals", [True, False],
                         ids=["host_literals", "device_literals"])
def test_plain_transcode_matches_reference_chains(monkeypatch,
                                                  host_literals):
    frames, raws = chain_frames(np.random.default_rng(91))
    res, calls = capture_transcode(monkeypatch, frames,
                                   [len(r) for r in raws],
                                   host_literals=host_literals)
    assert res == raws
    meta = np.concatenate([a[4] for a, _ in calls])
    assert len(meta) == 9 and (meta[:, 13] > 100).all()
    # one chain a frame: its first row resets the repcodes, two carry them
    assert ((meta[:, 0] & D.DMODE_FRAME_START) != 0).sum() == 3
    assert check_rows(calls) == 9
