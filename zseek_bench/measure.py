"""The benchmark's arithmetic: percentiles, rates, the union of device
intervals and the byte roofline of the card."""

from __future__ import annotations

import numpy as np

MIB = 1 << 20
# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W limit
HBM_BYTES_S = 3.35e12


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the nearest ranks (NumPy's
    default, as the port's chip_smoke.timed_read takes it).  A missing
    answer is given as inf and so sits above every other."""
    with np.errstate(invalid="ignore"):
        p = float(np.percentile(np.asarray(values, np.float64), q))
    return float("inf") if np.isnan(p) else p   # between a value and inf


def rate_mib_s(nbytes: int, seconds: float) -> float:
    return nbytes / MIB / seconds


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals (copied from the
    port's profile_write._union_us)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint intervals, in
    order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def byte_roofline_pct(nbytes: int, busy_s: float) -> float | None:
    """The least time the card's memory could move `nbytes` in (each byte
    read or written once), as a share of `busy_s` seconds of kernels."""
    if busy_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_S / busy_s
