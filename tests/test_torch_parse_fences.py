"""K1's wrapper (libzseek_tpu_torch/ops/parse_linked.py): the ordered
chains follow the min_abs fences, and the wrapper refuses the quad
loop's repcode arm (rep_probe without dual, which no level reaches) and
fences that cut no frame."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.ops.parse_linked import chain_bounds, parse_linked
from test_torch_inputs import fence_batch

N = 16384


def test_chain_bounds_follow_fences():
    assert chain_bounds(np.array([N, N, 2 * N, 4 * N]), N).tolist() == \
        [0, 3, 4]
    assert chain_bounds(np.array([N, 2 * N, 3 * N]), N).tolist() == \
        [0, 1, 2, 3]


def test_rejects_unported_arms_and_bad_fences():
    x2, lens, min_abs, h16 = (torch.from_numpy(a) for a in
                              fence_batch(np.random.default_rng(2024), N))
    # the quad loop's repcode arm (rep_probe without dual) is reached only
    # through the reference's retired ZN_REP_PROBE knob
    with pytest.raises(ParameterError, match="ZN_REP_PROBE"):
        parse_linked(x2, lens, min_abs, h16, rep_probe=True)
    with pytest.raises(ParameterError):
        parse_linked(x2, lens, min_abs, h16, lazy=1, rep_probe=True)
    with pytest.raises(ValueError):
        parse_linked(x2, lens, torch.zeros_like(min_abs), h16)
