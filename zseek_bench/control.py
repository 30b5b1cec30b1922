"""The control of `correct`: a run of a cell with a fault planted in the
timed path, which the comparison has to catch.  The benchmark's own runs
never plant one.

    python3 -m zseek_bench.control --workload <cell> --seed <n> --seconds <s> --fault <flip|drop|trunc|none>

flip  an answer altered where it is produced: one byte in the middle of
      every frame the Writer hands its sink, or of every pread's result.
      This breaks the configurations' first guarantee (lossless) and is
      the control that each cell's numbers were set against.
drop  half of the batch left out: every other frame the Writer hands its
      sink never reaches it, or the Reader serves zeros in place of the
      frames of odd index.
trunc an answer cut short where it is produced: every frame the Writer
      hands its sink loses its last byte, and so does every pread_full's
      result (as a pread_full that stopped short of its size would give)
      and every read of a scan.
none  nothing planted (the same run as the benchmark's).

Prints each number compared beside its limit and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from unittest import mock

from zseek_bench import drive, run

FRAME_MAGICS = (b"\x28\xb5\x2f\xfd", b"\x04\x22\x4d\x18")


def _flip(b: bytes) -> bytes:
    if not b:
        return b
    out = bytearray(b)
    out[len(out) // 2] ^= 0xFF
    return bytes(out)


@contextlib.contextmanager
def planted(fault: str, op: str):
    """The fault in place, in the timed path of a cell of traffic `op`
    (the Writer's output in a write cell, the Reader's in a read cell;
    the archive that a read cell's set-up writes stays sound)."""
    from libzseek_tpu_torch.runtime.reader import Reader
    if fault == "none":
        yield
        return
    write = drive.Sink.write
    if fault == "flip":
        def sink_write(self, b):
            if bytes(b[:4]) in FRAME_MAGICS:
                b = _flip(bytes(b))
            write(self, b)

        def reader_pread(self, size, offset):
            return _flip(orig(self, size, offset))
        name = "pread"
    elif fault == "drop":
        def sink_write(self, b):
            if bytes(b[:4]) in FRAME_MAGICS:
                self.frames_seen = getattr(self, "frames_seen", 0) + 1
                if self.frames_seen % 2 == 0:
                    return
            write(self, b)

        def reader_pread(self, size, offset):
            got = orig(self, size, offset)
            if self.seek_table.frame_for_offset(offset) % 2:
                return bytes(len(got))
            return got
        name = "pread"
    elif fault == "trunc":
        def sink_write(self, b):
            if bytes(b[:4]) in FRAME_MAGICS:
                b = bytes(b)[:-1]
            write(self, b)

        def reader_pread(self, *args):
            return orig(self, *args)[:-1]
        name = "read" if op == "scan" else "pread_full"
    else:
        raise ValueError(f"unknown fault {fault!r}")
    orig = getattr(Reader, name)
    if op == "write":
        with mock.patch.object(drive.Sink, "write", sink_write):
            yield
    else:
        with mock.patch.object(Reader, name, reader_pread):
            yield


def run_fault(workload: str, seed: int, seconds: float, fault: str,
              **kw) -> dict:
    from zseek_bench import spec
    op = spec.load(kw.get("root", run.ROOT), workload).mix["op"]
    with planted(fault, op):
        return run.run_cell(workload, seed, seconds, False, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m zseek_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=("flip", "drop", "trunc", "none"),
                    default="flip")
    a = ap.parse_args(argv)
    run._caches(run.ROOT)
    line = run_fault(a.workload, a.seed, a.seconds, a.fault)
    for k, c in line["checks"].items():
        print(f"control {a.fault} {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
