"""K1's level >= 4 arms (dual table, lazy matching, repcode probe) in the
port's plain version against the reference Pallas kernel
(libzseek_tpu/ops/pallas_match.zstd_parse_linked_smem) in interpret mode,
at levels 4 (lazy 1) and 9 (lazy 2), on the cases of
test_torch_parse_linked.py: the multi-frame fence batch, planted text,
the four mixed regimes, h16 on both sides of the strict threshold and
LDM-covered rows.

All six outputs must be equal array for array, including the slots past
n_seq.  Tolerance: none (integer outputs).  Level 16 and the crafted
cases of each arm: test_torch_parse_lazy.py."""

import numpy as np
import pytest

from libzseek_tpu.ops.zstd_encode import level_search_params
from test_torch_inputs import PARSE_OUTS, parse_both, parse_cases

CASES = parse_cases()


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    # the reference ladder is read without its ZN_* environment knobs
    for k in ("ZN_REP_PROBE", "ZN_GATE_BITS", "ZN_HLOG", "ZN_STRICT_X6",
              "ZN_STRICT_HB", "ZN_GATED_POLICY", "ZN_BLOCK"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("level", [4, 9])
def test_plain_parse_matches_reference_at_level(level):
    prm = level_search_params(level)
    assert prm["dual"] and prm["rep_probe"] and prm["lazy"] == \
        (1 if level == 4 else 2)
    for case in sorted(CASES):
        ref, out = parse_both(CASES[case], prm)
        for name, r, o in zip(PARSE_OUTS, ref, out):
            np.testing.assert_array_equal(o, r,
                                          err_msg=f"{case} L{level} {name}")
        if case != "fence":
            assert int(out[3].sum()) > 0, f"{case}: no matches"
