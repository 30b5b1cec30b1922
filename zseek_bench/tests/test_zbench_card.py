"""On the card: one short run of each cell through the command line, and
the control's flip fault in one, at the cells' own sizes.  Skips without
a card; run there with

    python3 -m pytest zseek_bench/tests -m cuda
"""

import json
import subprocess
import sys

import pytest

from zseek_bench import run


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _line(args):
    p = subprocess.run([sys.executable, "-m"] + args, cwd=run.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["zstd3_f1m.write", "lz4_f1m.write",
                                  "zstd3_f1m.scan", "zstd3_f1m.pread"])
def test_cell_runs_correct_on_the_card(card, cell):
    line = _line(["zseek_bench.run", "--workload", cell, "--seed", "17",
                  "--seconds", "2", "--trace", "0"])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    line = _line(["zseek_bench.control", "--workload", "zstd3_f1m.pread",
                  "--seed", "18", "--seconds", "2", "--fault", "flip"])
    assert not line["correct"]
