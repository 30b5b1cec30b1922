"""K1 (libzseek_tpu_torch/ops/parse_linked.py): the plain version of the
linked gated parse against the reference Pallas kernel
(libzseek_tpu/ops/pallas_match.zstd_parse_linked_smem) in interpret mode.

All six outputs (ll, ml, offv, n_seq, cover_end, lit_mask) must be equal
array for array, including the slots past n_seq.  Tolerance: none (integer
outputs).  Rows are 16 KiB blocks; every case has the same shape, so the
reference compiles once per level.  The level >= 4 arms:
test_torch_parse_levels.py and test_torch_parse_lazy.py; the chain bounds
and the wrapper's refusals: test_torch_parse_fences.py."""

import numpy as np
import pytest

from libzseek_tpu.ops.zstd_encode import level_search_params
from test_torch_inputs import PARSE_OUTS, parse_both, parse_cases

CASES = parse_cases()


@pytest.mark.parametrize("level", [1, 3])
def test_plain_parse_matches_reference(level):
    prm = level_search_params(level)
    prm = dict(min_match=prm["min_match"], accel_log=prm["accel_log"])
    for case in sorted(CASES):
        ref, out = parse_both(CASES[case], prm)
        for name, r, o in zip(PARSE_OUTS, ref, out):
            np.testing.assert_array_equal(o, r,
                                          err_msg=f"{case} L{level} {name}")
        if case != "fence":
            assert int(out[3].sum()) > 0, f"{case}: no matches"
