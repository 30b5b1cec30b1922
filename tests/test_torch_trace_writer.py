"""The Writer's spans: zseek.finish on its finishing thread, caused by a
zseek.dispatch on the calling thread, and the calling thread's waits."""

import threading

import pytest

from libzseek_tpu_torch.utils import trace
from test_torch_trace_inputs import archive, on
from test_torch_trace_inputs import empty_log  # noqa: F401


@pytest.mark.parametrize("codec,thread", [("zstd", "zseek-finish"),
                                          ("lz4", "zseek-lz4")])
def test_writer_logs_its_finishing_thread(codec, thread):
    with on():
        archive(codec, frames=32)
    log = trace.spans()
    by_id = {s.id: s for s in log}
    me = threading.current_thread().name
    fin = [s for s in log if s.name == "zseek.finish"]
    assert len(fin) == 4 and all(s.thread.startswith(thread) for s in fin)
    assert all(by_id[s.cause].name == "zseek.dispatch" and
               by_id[s.cause].thread == me for s in fin)
    fetch = [s for s in log if s.name == "zseek.fetch"]
    assert fetch and all(by_id[s.cause].name == "zseek.finish"
                         for s in fetch)
    for name in ("zseek.stream_wait", "zseek.sink", "zseek.assemble",
                 "zseek.layout"):
        assert any(s.name == name and s.thread == me for s in log), name
