"""The port's span helper (libzseek_tpu_torch/utils/trace.py), off and on:
off, a span is one flag read and nothing else; on (a torch.profiler
running), it enters record_function and logs name, thread, start and end
on the profiler's clock, its id and its cause.  The helper's other cases,
and the spans of the Reader's and Writer's threads, are in
tests/test_torch_trace_*.py."""

import threading

from libzseek_tpu_torch.utils import trace
from test_torch_trace_inputs import count_record_function, on
from test_torch_trace_inputs import empty_log  # noqa: F401


def test_off_enters_nothing_and_logs_nothing(monkeypatch):
    entered = count_record_function(monkeypatch)
    with trace.span("zseek.t_off") as s:
        assert trace.current() is None
    assert s is None and entered == []
    assert trace.span("zseek.a") is trace.span("zseek.b")   # one null context
    assert trace.spans() == [] and trace.dropped() == 0


def test_on_enters_record_function_and_logs_one_entry(monkeypatch):
    entered = count_record_function(monkeypatch)
    with on():
        assert trace.current() is None
        with trace.span("zseek.t_on"):
            sid = trace.current()
            assert sid is not None
        assert trace.current() is None
    assert entered == ["zseek.t_on"]
    (s,) = trace.spans()
    assert (s.name, s.thread, s.id, s.cause) == \
        ("zseek.t_on", threading.current_thread().name, sid, None)
    assert 0 < s.start_ns <= s.end_ns
