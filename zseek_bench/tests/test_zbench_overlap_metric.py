"""The reader of lz4_overlap_pct.write on a synthetic span log: the
zseek.overlap marks over the zseek.dispatch spans of the calling thread,
in percent; 0 where dispatches carry no mark; None where the port has no
span log, for an untraced run and for a cell of another op."""

import sys

import pytest

import libzseek_tpu_torch.utils
from libzseek_tpu_torch.utils import trace
from zseek_bench import run, spec
from zseek_bench.drive import Record
from zseek_bench.measure import MIB
from zseek_bench.trace import Trace

read = spec.reader(run.ROOT, "lz4_overlap_pct.write")


def _rec(op, traced=True):
    rec = Record(op, window_s=51.0)
    rec.in_bytes = 4 * MIB
    rec.trace = Trace(51.0, [], [], {}, {}, [], []) if traced else None
    return rec


def _log(monkeypatch, entries):
    spans = [trace.Span(name, thread, a, a + d, i + 1, None)
             for i, (name, thread, a, d) in enumerate(entries)]
    monkeypatch.setattr(trace, "spans", lambda: list(spans))


def test_overlap_share_of_dispatches(monkeypatch):
    dispatch = [("zseek.dispatch", "MainThread", t, 10) for t in (0, 20,
                                                                  40, 60)]
    _log(monkeypatch, dispatch + [
        ("zseek.overlap", "MainThread", 25, 0),
        ("zseek.overlap", "MainThread", 65, 0),
        ("zseek.overlap", "zseek-lz4_0", 70, 0),
        ("zseek.fetch", "zseek-lz4_0", 0, 30)])
    assert read(_rec("write")) == pytest.approx(50.0)
    assert read(_rec("write", traced=False)) is None
    assert read(_rec("scan")) is None
    _log(monkeypatch, dispatch)
    assert read(_rec("write")) == 0.0
    _log(monkeypatch, [("zseek.fetch", "zseek-lz4_0", 0, 30)])
    assert read(_rec("write")) is None


def test_overlap_is_none_without_the_span_log(monkeypatch):
    """A port without utils/trace.py (an older commit): no value, no
    error."""
    monkeypatch.delattr(libzseek_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "libzseek_tpu_torch.utils.trace", None)
    assert read(_rec("write")) is None
