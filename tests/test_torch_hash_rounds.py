"""K7's round mirror (ops/hash_parse.parse_rounds: the CUDA kernel's walk
a round of 32 positions at a time, in Python) against the plain walk and
the Pallas kernel in interpret mode.

Outputs up to each row's n_seq, n_seq and cover_end must be equal
(tolerance: none)."""

import torch

from libzseek_tpu_torch.ops import hash_parse as HP
from test_torch_cuda_inputs import k7_edge_rows
from test_torch_hash_inputs import (block_rows, k7_plain, k7_reference,
                                    small_rows)


def _rounds(X, lens):
    cap = HP.default_cap(X.shape[1])
    return [HP.parse_rounds(X[i], int(lens[i]), cap)
            for i in range(len(lens))]


def _same(rounds, ref):
    for i, got in enumerate(rounds):
        n = int(ref[3][i])
        assert (got[3], got[4]) == (n, int(ref[4][i])), i
        for k in range(3):
            assert got[k] == ref[k][i, :n].tolist(), (i, k)


def test_rounds_match_pallas_and_plain():
    """tests/test_pallas_parse.py's four 16 KiB rows (text, mixed, zeros,
    period-337 repeats) against the Pallas kernel; 128 KiB log-like and
    mixed rows and a short last text row against the plain walk."""
    X, lens = small_rows()
    _same(_rounds(X, lens), k7_reference(X, lens))
    X, lens = block_rows()
    _same(_rounds(X, lens), k7_plain("blocks"))


def test_rounds_take_every_arm():
    """test_torch_cuda_inputs.k7_edge_rows against the plain walk: rounds
    cut before a skipped forwarding lane and before a hit past cap (a row
    that reaches cap), long matches extended by the warp, rounds past 32
    misses, the offset 131059 and short rows."""
    X, lens = k7_edge_rows()
    ref = [a.numpy() for a in HP.hash_parse(torch.from_numpy(X),
                                            torch.from_numpy(lens))]
    rounds = _rounds(X, lens)
    _same(rounds, ref)
    stats = {k: sum(r[5][k] for r in rounds) for k in rounds[0][5]}
    assert min(stats["cut_forward"], stats["cut_cap"], stats["long"]) > 0
    assert stats["dense"] < stats["rounds"]
    assert ref[3][1] == HP.default_cap(X.shape[1])
    assert max(rounds[5][2]) - 3 == 131059
