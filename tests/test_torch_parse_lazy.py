"""K1's level >= 4 arms in the port's plain version against the reference
Pallas kernel in interpret mode: level 16 on the cases of
test_torch_parse_linked.py, and a batch crafted so that each arm decides
a match (tests/test_torch_inputs.arms_batch) at levels 4, 9 and 16.

All six outputs must be equal array for array (tolerance: none); the
crafted rows must also show their arm at work in the plain output: the
lazy step's match (one step at level 4, two at 9 and 16), 5-7-byte
matches in a strict row (short4), and a repcode match that the parse
without rep_probe does not find."""

import numpy as np
import pytest
import torch

from libzseek_tpu.ops.zstd_encode import level_search_params
from libzseek_tpu_torch.ops.parse_linked import parse_linked
from test_torch_cuda_inputs import LAZY_AT, REP_AT
from test_torch_inputs import (PARSE_OUTS, arms_batch, kept_sequences,
                               parse_both, parse_cases)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in ("ZN_REP_PROBE", "ZN_GATE_BITS", "ZN_HLOG", "ZN_STRICT_X6",
              "ZN_STRICT_HB", "ZN_GATED_POLICY", "ZN_BLOCK"):
        monkeypatch.delenv(k, raising=False)


def _same(ref, out, msg):
    for name, r, o in zip(PARSE_OUTS, ref, out):
        np.testing.assert_array_equal(o, r, err_msg=f"{msg} {name}")


def test_plain_parse_matches_reference_at_level_16():
    prm = level_search_params(16)
    cases = parse_cases()
    for case in sorted(cases):
        ref, out = parse_both(cases[case], prm)
        _same(ref, out, f"{case} L16")


def test_crafted_arms_match_reference():
    case = arms_batch()
    h16 = case[3]
    assert 6 * h16[1] <= 480 < 6 * min(h16[0], h16[2]), h16
    for level in (4, 9, 16):
        prm = level_search_params(level)
        ref, out = parse_both(case, prm)
        _same(ref, out, f"arms L{level}")
        # lazy: the match starts one (two) bytes after the short hit
        start, dist, ln = LAZY_AT[prm["lazy"]]
        assert any(s == start and d == dist and m >= ln
                   for s, m, d in kept_sequences(out, 0)), level
        # short4: kept 5-7-byte matches at a new distance in a strict row
        seqs = kept_sequences(out, 1)
        assert any(5 <= m <= 7 and (j == 0 or d != seqs[j - 1][2])
                   for j, (s, m, d) in enumerate(seqs)), level
        # rep_probe: the 64-byte repcode match, which the parse without
        # the probe splits
        start, dist, ln = REP_AT
        assert any(s == start and d == dist and m >= ln
                   for s, m, d in kept_sequences(out, 2)), level
        norep = parse_linked(*(torch.from_numpy(a) for a in case),
                             **dict(prm, rep_probe=False))
        assert (start, dist) not in [
            (s, d) for s, m, d in kept_sequences([o.numpy() for o in norep],
                                                 2) if m >= ln], level
