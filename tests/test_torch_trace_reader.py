"""The Reader's spans: a scan logs zseek.prefetch and its stages on the
prefetch threads, each caused by a zseek.pread on the calling thread."""

import threading

import pytest

from libzseek_tpu_torch import Reader
from libzseek_tpu_torch.utils import trace
from test_torch_trace_inputs import FRAME, archive, on
from test_torch_trace_inputs import empty_log  # noqa: F401


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_reader_scan_logs_the_prefetch_threads(codec):
    data, arch = archive(codec)
    with on():
        r = Reader(arch, device="cpu", cache_frames=8)
        got = bytearray()
        while chunk := r.read(FRAME):
            got += chunk
        r.close()
    assert bytes(got) == data
    log = trace.spans()
    by_id = {s.id: s for s in log}
    me = threading.current_thread().name
    pre = [s for s in log if s.name == "zseek.prefetch"]
    assert pre and all(s.thread.startswith("zseek-prefetch") for s in pre)
    assert all(by_id[s.cause].thread == me and
               by_id[s.cause].name == "zseek.pread" for s in pre)
    # the stages under a prefetch window run on its thread
    pre_ids = {s.id for s in pre}
    stages = [s for s in log if s.cause in pre_ids]
    assert {s.name for s in stages} >= {"zseek.source"}
    assert all(s.thread == by_id[s.cause].thread for s in stages)
    waits = [s for s in log if s.name == "zseek.prefetch_wait"]
    assert waits and all(s.thread == me for s in waits)
