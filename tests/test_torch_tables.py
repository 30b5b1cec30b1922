"""The port's entropy-kernel constants equal the JAX reference's: the
constant pack and per-row table layout, the mode bits and anchor
intervals, and the whole level ladder (levels -7 to 22).  Exact
equality (integer tables).  The parse, codec and planner constants:
test_torch_tables_plan.py and test_torch_cost_table.py."""

import numpy as np

from libzseek_tpu.ops import pallas_entropy as jpe
from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import zstd_encode as ze


def test_entropy_constant_pack():
    np.testing.assert_array_equal(E.TABS, jpe._TABS)
    assert E.TAB_OFF == jpe._OFF
    np.testing.assert_array_equal(E.CTAB_PREDEF, jpe.CTAB_PREDEF)
    assert E.CTAB_WIDTH == jpe.CTAB_WIDTH
    assert E.CTAB_OFF == jpe._CTO
    assert E.CT_MAXLOG == jpe.CT_MAXLOG
    assert E.MODE_LOG_SHIFT == jpe.MODE_LOG_SHIFT


def test_mode_bits_and_level_ladder():
    for name in ("MODE_HUF", "MODE_RAWLIT", "MODE_SEQ", "MODE_HUF1",
                 "MODE_LL_RLE", "MODE_OF_RLE", "MODE_ML_RLE", "MODE_LL_FSE",
                 "MODE_OF_FSE", "MODE_ML_FSE", "LIT_ANCHOR_INTERVAL",
                 "SEQ_ANCHOR_INTERVAL"):
        assert getattr(E, name) == getattr(jpe, name), name
    for level in range(-7, 23):
        assert ze.level_search_params(level) == \
            jze.level_search_params(level), level
