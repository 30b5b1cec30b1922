"""The readers of the span metrics: prefetch_wait_ms_per_MiB.scan and
stream_wait_ms_per_MiB.write (self time of a calling-thread range in the
Trace), prefetch_ms_per_MiB.scan and finish_ms_per_MiB.write (worker
spans in the port's span log), on a synthetic Record and log.  Each
returns None for a cell of another op and where its spans are absent."""

import pytest

from libzseek_tpu_torch.utils import trace
from zseek_bench import run, spec
from zseek_bench.drive import Record
from zseek_bench.measure import MIB
from zseek_bench.trace import Trace

READERS = {n: spec.reader(run.ROOT, n) for n in (
    "prefetch_wait_ms_per_MiB.scan", "prefetch_ms_per_MiB.scan",
    "stream_wait_ms_per_MiB.write", "finish_ms_per_MiB.write")}


def _trace(span_self_s):
    return Trace(51.0, [], [], span_self_s, {}, [], [])


def _rec(op, span_self_s=None, mib=4):
    rec = Record(op, window_s=51.0)
    rec.read_bytes = rec.in_bytes = mib * MIB
    rec.trace = None if span_self_s is None else _trace(span_self_s)
    return rec


def _log(monkeypatch, entries):
    spans = [trace.Span(name, thread, a, b, i + 1, None)
             for i, (name, thread, a, b) in enumerate(entries)]
    monkeypatch.setattr(trace, "spans", lambda: list(spans))


def test_prefetch_wait_is_self_time_per_MiB_read():
    read = READERS["prefetch_wait_ms_per_MiB.scan"]
    assert read(_rec("scan", {"zseek.prefetch_wait": 2.0})) == \
        pytest.approx(500.0)
    assert read(_rec("scan", {"zseek.pread": 1.0})) is None
    assert read(_rec("scan")) is None
    assert read(_rec("write", {"zseek.prefetch_wait": 2.0})) is None


def test_stream_wait_is_self_time_per_MiB_written():
    read = READERS["stream_wait_ms_per_MiB.write"]
    assert read(_rec("write", {"zseek.stream_wait": 0.5}, mib=2)) == \
        pytest.approx(250.0)
    assert read(_rec("write", {"zseek.plan": 1.0})) is None
    assert read(_rec("write")) is None
    assert read(_rec("scan", {"zseek.stream_wait": 0.5})) is None


def test_prefetch_sums_the_prefetch_threads_spans(monkeypatch):
    read = READERS["prefetch_ms_per_MiB.scan"]
    _log(monkeypatch, [
        ("zseek.prefetch", "zseek-prefetch_0", 0, 3_000_000),
        ("zseek.prefetch", "zseek-prefetch_1", 1_000_000, 6_000_000),
        ("zseek.source", "zseek-prefetch_0", 0, 1_000_000),
        ("zseek.prefetch", "MainThread", 0, 9_000_000),
        ("zseek.finish", "zseek-finish_0", 0, 9_000_000)])
    # 3 ms + 5 ms on the two threads (overlapping), over 4 MiB
    assert read(_rec("scan", {})) == pytest.approx(2.0)
    assert read(_rec("write", {})) is None
    assert read(_rec("scan")) is None          # an untraced run
    _log(monkeypatch, [("zseek.source", "zseek-prefetch_0", 0, 10)])
    assert read(_rec("scan", {})) is None


def test_finish_sums_the_finishing_threads_spans(monkeypatch):
    read = READERS["finish_ms_per_MiB.write"]
    _log(monkeypatch, [
        ("zseek.finish", "zseek-finish_0", 0, 4_000_000),
        ("zseek.finish", "zseek-lz4_0", 0, 2_000_000),
        ("zseek.fetch", "zseek-finish_0", 0, 1_000_000),
        ("zseek.finish", "MainThread", 0, 9_000_000),
        ("zseek.prefetch", "zseek-prefetch_0", 0, 9_000_000)])
    assert read(_rec("write", {}, mib=3)) == pytest.approx(2.0)
    assert read(_rec("scan", {})) is None
    assert read(_rec("write")) is None
    _log(monkeypatch, [])
    assert read(_rec("write", {})) is None


def test_span_log_readers_give_none_without_the_span_log(monkeypatch):
    """A port without utils/trace.py (an older commit): no value, no
    error."""
    import sys
    import libzseek_tpu_torch.utils
    _log(monkeypatch, [("zseek.prefetch", "zseek-prefetch_0", 0, 10**6),
                       ("zseek.finish", "zseek-finish_0", 0, 10**6)])
    assert READERS["prefetch_ms_per_MiB.scan"](_rec("scan", {})) > 0
    monkeypatch.delattr(libzseek_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "libzseek_tpu_torch.utils.trace", None)
    assert READERS["prefetch_ms_per_MiB.scan"](_rec("scan", {})) is None
    assert READERS["finish_ms_per_MiB.write"](_rec("write", {})) is None
