"""The readers of worker_busy.write (zseek.worker spans on the zstd
stream's zseek-worker-<i> threads over the traced window) and
worker_host_ms_per_MiB.write (zseek.layout and zseek.plan on those
threads per MiB written), on synthetic span logs.  Each reads None
without the span log, on a one-worker log (the same stages on the calling
and finishing threads), for an untraced run and for a cell of another
op."""

import sys

import pytest

import libzseek_tpu_torch.utils
from libzseek_tpu_torch.utils import trace
from zseek_bench import run, spec
from zseek_bench.drive import Record
from zseek_bench.measure import MIB
from zseek_bench.trace import Trace

READERS = {n: spec.reader(run.ROOT, n) for n in (
    "worker_busy.write", "worker_host_ms_per_MiB.write")}
MS = 1_000_000


def _rec(op="write", traced=True, window_s=2.0, mib=4):
    rec = Record(op, window_s=window_s)
    rec.in_bytes = mib * MIB
    rec.trace = Trace(window_s, [], [], {}, {}, [], []) if traced else None
    return rec


def _log(monkeypatch, entries):
    spans = [trace.Span(name, thread, a * MS, b * MS, i + 1, None)
             for i, (name, thread, a, b) in enumerate(entries)]
    monkeypatch.setattr(trace, "spans", lambda: list(spans))


ONE_WORKER = [("zseek.dispatch", "MainThread", 0, 900),
              ("zseek.layout", "MainThread", 0, 300),
              ("zseek.plan", "MainThread", 300, 800),
              ("zseek.finish", "zseek-finish_0", 800, 1000)]


def test_worker_readers_on_four_workers(monkeypatch):
    # four workers, 3 s of batches in all over a 2 s window; 1.2 s of
    # layout and plans on them, over 4 MiB; the calling thread's own
    # dispatch spans and a worker's fetch are not counted
    _log(monkeypatch, ONE_WORKER + [
        ("zseek.worker", "zseek-worker-0", 0, 1000),
        ("zseek.worker", "zseek-worker-1", 0, 500),
        ("zseek.worker", "zseek-worker-2", 500, 1500),
        ("zseek.worker", "zseek-worker-3", 1500, 2000),
        ("zseek.layout", "zseek-worker-0", 0, 200),
        ("zseek.plan", "zseek-worker-0", 200, 700),
        ("zseek.plan", "zseek-worker-3", 1500, 2000),
        ("zseek.fetch", "zseek-worker-2", 500, 1500)])
    busy = READERS["worker_busy.write"]
    host = READERS["worker_host_ms_per_MiB.write"]
    assert busy(_rec()) == pytest.approx(1.5)
    assert host(_rec()) == pytest.approx(300.0)
    for read in (busy, host):
        assert read(_rec(traced=False)) is None
        assert read(_rec("scan")) is None
    _log(monkeypatch, ONE_WORKER)
    assert busy(_rec()) is None and host(_rec()) is None


def test_worker_readers_give_none_without_the_span_log(monkeypatch):
    """A port without utils/trace.py (an older commit): no value, no
    error."""
    _log(monkeypatch, [("zseek.worker", "zseek-worker-0", 0, 1000),
                       ("zseek.plan", "zseek-worker-0", 0, 500)])
    assert READERS["worker_busy.write"](_rec()) > 0
    monkeypatch.delattr(libzseek_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "libzseek_tpu_torch.utils.trace", None)
    for read in READERS.values():
        assert read(_rec()) is None
