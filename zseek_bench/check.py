"""What decides `correct`: the window's own outputs held to the plain
reference (reference/) and to the input, which the benchmark made from
the seed.  Each number has its limit; every limit is 0, as each is a
count of answers that differ from the input or never came.

write cells   archives_malformed  distinct archives that the window kept
                                  (its first, and a quarter of the others
                                  drawn from the seed) whose seek table,
                                  frame headers or layout do not match
                                  the input (all are walked)
              frames_wrong        frames whose plain decode differs from
                                  their span of the input: every frame of
                                  one kept archive drawn from the seed,
                                  and FRAMES_DRAWN more, a stratum each,
                                  out of the other kept archives
              calls_failed        Writer calls that raised
read cells    reads_wrong         answers that differ from the input, in
                                  length or in a byte: every pread of the
                                  window; every scan pass by its length,
                                  and the first and an eighth of the
                                  rest, drawn from the seed, byte for byte
              calls_failed        Reader calls that raised
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np

from zseek_bench.reference import archive as ref

FRAMES_DRAWN = 8


def frame_strata(n_frames: int, k: int, rng: np.random.Generator) -> list:
    """One frame index drawn from each of k equal runs of the frames, so
    that every region of the input has its turn."""
    edges = np.linspace(0, n_frames, k + 1).astype(int)
    return [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])
            if b > a]


def _say(msg: str) -> None:
    print(f"check: {msg}", file=sys.stderr)


def check_write(archives: list, data: bytes, codec: str, seed: int,
                failed: int) -> dict:
    distinct = {}
    for a in archives:
        distinct.setdefault(hashlib.sha256(a).digest(), a)
    good, malformed = [], 0
    for a in distinct.values():
        try:
            frames = ref.structure(a, codec)
            if sum(d for _, _, d in frames) != len(data):
                raise ref.ArchiveError("the frames do not add up to the "
                                       "input")
        except (ValueError,) + ref.MALFORMED as e:
            malformed += 1
            _say(f"archive of {len(a)} bytes malformed: {e}")
            continue
        good.append((a, frames))
    if not good:
        return {"archives_malformed": (malformed, 0),
                "frames_wrong": (FRAMES_DRAWN, 0),
                "calls_failed": (failed, 0)}
    rng = np.random.default_rng([seed, 7])
    whole = int(rng.integers(len(good)))
    picks = [(whole, i) for i in range(len(good[whole][1]))]
    rest = [k for k in range(len(good)) if k != whole] or [whole]
    for _ in range(FRAMES_DRAWN // 4):
        k = rest[int(rng.integers(len(rest)))]
        picks += [(k, i) for i in frame_strata(len(good[k][1]), 4, rng)]
    wrong = 0
    for k, i in picks:
        a, frames = good[k]
        off, c, d = frames[i]
        d_off = sum(f[2] for f in frames[:i])
        want = data[d_off: d_off + d]
        try:
            got = ref.decode_frame(a, off, c, codec)
        except ValueError as e:
            if wrong < 5:
                _say(f"frame {i}: the plain decoder refused it: {e}")
            wrong += 1
            continue
        if got != want:
            if wrong < 5:
                _say(f"frame {i}: {_differ(got, want)}")
            wrong += 1
    _say(f"{len(picks)} frames decoded, of {len(good)} distinct archives")
    return {"archives_malformed": (malformed, 0),
            "frames_wrong": (wrong, 0), "calls_failed": (failed, 0)}


def _differ(got: bytes, want: bytes) -> str:
    n = min(len(got), len(want))
    a = np.frombuffer(got[:n], np.uint8)
    b = np.frombuffer(want[:n], np.uint8)
    bad = np.flatnonzero(a != b)
    first = int(bad[0]) if len(bad) else n
    return (f"{len(bad)} bytes differ, the first at {first}; "
            f"{len(got)} bytes against {len(want)}")


def check_reads(answers: list, data: bytes, size: int,
                failed: int) -> dict:
    """answers: (offset, bytes) of every pread of the window, each of
    which asked for `size` bytes where the input has them."""
    wrong = 0
    for off, got in answers:
        want = data[off: off + size]
        if got != want:
            if wrong < 5:
                _say(f"read at {off}: {_differ(got, want)}")
            wrong += 1
    return {"reads_wrong": (wrong, 0), "calls_failed": (failed, 0)}


def check_passes(passes: list, data: bytes, failed: int) -> dict:
    """passes: (parts, bytes returned) of every scan pass, whose parts
    (kept for a sample drawn from the seed) are the whole input in order;
    every pass has to return the input's length."""
    wrong = 0
    for k, (parts, n) in enumerate(passes):
        got = None if parts is None else b"".join(parts)
        if n != len(data) or (got is not None and got != data):
            if wrong < 5:
                _say(f"pass {k}: " + (_differ(got, data) if got is not None
                                     else f"{n} bytes of {len(data)}"))
            wrong += 1
    return {"reads_wrong": (wrong, 0), "calls_failed": (failed, 0)}
