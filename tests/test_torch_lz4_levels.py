"""K5's level arms (LZ4Codec._level_params): plain K5 against the Pallas
kernel in interpret mode on linked 64 KiB rows of every mixed-corpus
regime, at level -1 (accel_log 5) and level 3 (lazy 1, accel_log 8)."""

import pytest

from libzseek_tpu_torch.runtime.codec import LZ4Codec
from test_torch_lz4_inputs import both_k5, level_rows


@pytest.mark.parametrize("level", [-1, 3])
def test_level_arms(level):
    ref, got = both_k5(*level_rows(50 + level),
                       **LZ4Codec._level_params(level))
    assert got == ref
