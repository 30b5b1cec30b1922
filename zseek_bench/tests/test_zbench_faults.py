"""Each fault that a cell can have, planted in the timed path of a run
that skips the look for a card (the port's plain kernels on the CPU at a
small size), turns `correct` false; with nothing planted it stays true.
The same faults at the cells' own sizes on the card: control.py."""

import pytest

from zseek_bench import control

SMALL = {"input_bytes": 1 << 18, "min_frame_size": 1 << 16,
         "write_bytes": 1 << 16}
CELLS = ["zstd3_f1m.write", "lz4_f1m.write", "zstd3_f1m.scan",
         "zstd3_f1m.pread"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["none", "flip", "drop", "trunc"])
def test_fault_is_caught(cell, fault):
    line = control.run_fault(cell, 31, 0.2, fault, device="cpu",
                             overrides=SMALL)
    assert line["correct"] is (fault == "none"), line["checks"]
