"""K5's level-9 arm (lazy 2, accel_log 12) and the default arm on the
same rows: plain K5 against the Pallas kernel in interpret mode."""

import pytest

from libzseek_tpu_torch.runtime.codec import LZ4Codec
from test_torch_lz4_inputs import both_k5, level_rows


@pytest.mark.parametrize("level", [0, 9])
def test_level_arms_default_and_hc(level):
    ref, got = both_k5(*level_rows(60 + level),
                       **LZ4Codec._level_params(level))
    assert got == ref
