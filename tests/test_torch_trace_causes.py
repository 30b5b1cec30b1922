"""Span causes and self times: a nested span names its enclosing span, and
a span handed to a pool thread names the submitting span."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from libzseek_tpu_torch.utils import trace
from test_torch_trace_inputs import on
from test_torch_trace_inputs import empty_log  # noqa: F401


def test_nesting_gives_causes_and_self_times():
    with on():
        with trace.span("zseek.outer"):
            time.sleep(0.002)
            with trace.span("zseek.inner"):
                time.sleep(0.004)
            with trace.span("zseek.inner"):
                time.sleep(0.004)
        with trace.span("zseek.other", cause=12345):
            pass
    log = trace.spans()
    outer = next(s for s in log if s.name == "zseek.outer")
    inner = [s for s in log if s.name == "zseek.inner"]
    other = next(s for s in log if s.name == "zseek.other")
    assert outer.cause is None and other.cause == 12345
    assert [s.cause for s in inner] == [outer.id, outer.id]
    own = trace.self_ns(log)
    spent = sum(s.end_ns - s.start_ns for s in inner)
    assert own[outer.id] == outer.end_ns - outer.start_ns - spent
    assert own[outer.id] >= 2_000_000
    assert all(own[s.id] == s.end_ns - s.start_ns for s in inner)


def test_hand_off_to_a_pool_thread_names_the_submitting_span():
    def work(cause):
        with trace.span("zseek.work", cause):
            with trace.span("zseek.step"):
                pass
        with trace.span("zseek.loose"):
            pass

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="t-pool")
    with on():
        with trace.span("zseek.queue"):
            pool.submit(work, trace.current()).result()
    pool.shutdown()
    log = {s.name: s for s in trace.spans()}
    me = threading.current_thread().name
    assert log["zseek.queue"].thread == me
    assert all(log[n].thread.startswith("t-pool")
               for n in ("zseek.work", "zseek.step", "zseek.loose"))
    assert log["zseek.work"].cause == log["zseek.queue"].id
    assert log["zseek.step"].cause == log["zseek.work"].id
    # a thread's open spans are its own: nothing encloses this one there
    assert log["zseek.loose"].cause is None
    assert len({s.id for s in log.values()}) == len(log)
    # the worker's time is not taken from the submitting span's self time
    own = trace.self_ns(list(log.values()))
    q = log["zseek.queue"]
    assert own[q.id] == q.end_ns - q.start_ns
