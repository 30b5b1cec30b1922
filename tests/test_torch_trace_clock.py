"""Reading the span log: drain() empties it and spans() copies it, and its
times are on the profiler's clock."""

import statistics
import time

from libzseek_tpu_torch.utils import trace
from test_torch_trace_inputs import on
from test_torch_trace_inputs import empty_log  # noqa: F401


def test_drain_empties_the_log_and_spans_copies_it():
    with on():
        for _ in range(3):
            with trace.span("zseek.t_drain"):
                pass
    a = trace.spans()
    a.clear()
    assert len(trace.spans()) == 3
    assert len(trace.drain()) == 3
    assert trace.spans() == [] and trace.drain() == []
    assert trace.dropped() == 0


def test_the_log_is_on_the_profilers_clock():
    """Calling-thread spans: the log entry and the profiler's event of the
    same span differ by under 1 ms at each end (medians over 20 spans;
    one preempted span on a loaded machine may stray further)."""
    names = [f"zseek.t_clock{i}" for i in range(20)]
    with on() as prof:
        for n in names:
            with trace.span(n):
                time.sleep(0.001)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    log = {s.name: s for s in trace.spans()}
    assert set(events) == set(names) == set(log)
    starts = [abs(log[n].start_ns - events[n].start_ns()) for n in names]
    ends = [abs(log[n].end_ns - events[n].start_ns() -
                events[n].duration_ns()) for n in names]
    assert statistics.median(starts) < 1_000_000
    assert statistics.median(ends) < 1_000_000
