"""The span log's bound: entries past it are counted as dropped, from one
thread and from many."""

import threading

from libzseek_tpu_torch.utils import trace
from test_torch_trace_inputs import on
from test_torch_trace_inputs import empty_log  # noqa: F401


def test_the_log_stops_at_its_bound_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(trace, "LOG_MAX", 5)
    with on():
        for _ in range(8):
            with trace.span("zseek.t_bound"):
                pass
    assert len(trace.spans()) == 5 and trace.dropped() == 3


def test_threads_lose_no_entry_and_share_no_id(monkeypatch):
    """More threads than cores, switching often, against a small bound:
    every span is kept or counted as dropped, and the ids are distinct."""
    import os
    import sys
    threads, each = 2 * (os.cpu_count() or 4) + 2, 200
    monkeypatch.setattr(trace, "LOG_MAX", threads * each // 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with on():
            def work():
                for _ in range(each):
                    with trace.span("zseek.t_stress"):
                        with trace.span("zseek.t_inner"):
                            pass
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    log = trace.spans()
    assert len(log) == threads * each // 2
    assert len(log) + trace.dropped() == 2 * threads * each
    assert len({s.id for s in log}) == len(log)
    by_id = {s.id: s for s in log}
    assert all(by_id[s.cause].thread == s.thread for s in log
               if s.cause in by_id)
