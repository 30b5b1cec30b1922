"""The benchmark's arithmetic on made-up numbers: percentiles, rates, the
union of device intervals, the byte roofline, and the trace reduction's
self times and idle gaps."""

import math

import numpy as np

from zseek_bench import measure, trace


def test_percentile_is_numpys_linear_and_a_missing_answer_sits_above():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert measure.percentile(v, 50) == 3.0
    assert measure.percentile(v, 99) == float(np.percentile(v, 99))
    assert math.isclose(measure.percentile(list(range(101)), 99), 99.0)
    assert measure.percentile([1.0] * 200 + [float("inf")] * 3, 99) == \
        float("inf")


def test_rate():
    assert measure.rate_mib_s(64 << 20, 2.0) == 32.0


def test_union_and_merge_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 10.5)]
    assert measure.union_s(iv) == 3.5
    assert measure.merged(iv) == [(0.0, 2.0), (3.0, 4.0), (10.0, 10.5)]
    assert measure.union_s([]) == 0.0


def test_byte_roofline():
    # 3.35 GB in 1 s of kernels against 3.35 TB/s: 0.1 %
    assert math.isclose(measure.byte_roofline_pct(3_350_000_000, 1.0), 0.1)
    assert measure.byte_roofline_pct(10, 0.0) is None


def test_self_times_subtract_nested_ranges():
    spans = [("zseek.a", 0.0, 10.0), ("zseek.b", 2.0, 5.0),
             ("zseek.c", 3.0, 4.0), ("zseek.b", 6.0, 7.0)]
    self_s, calls, pieces = trace._self_times(spans)
    assert self_s == {"zseek.a": 6.0, "zseek.b": 3.0, "zseek.c": 1.0}
    assert calls == {"zseek.a": 1, "zseek.b": 2, "zseek.c": 1}
    assert sum(b - a for a, b, _ in pieces) == 10.0


def test_idle_gaps_by_innermost_range():
    _, _, pieces = trace._self_times([("zseek.a", 0.0, 4.0),
                                      ("zseek.b", 1.0, 2.0)])
    busy = [(0.5, 1.5), (3.0, 6.0)]
    gaps = trace._gaps_by_span(busy, pieces, 0.0, 8.0)
    # idle: [0, .5) in a, [1.5, 2) in b, [2, 3) in a, [6, 8) outside
    assert gaps == {"zseek.a": 1.5, "zseek.b": 0.5, "host": 2.0}
