"""The zstd stream's worker pipelines at their edges (as
tests/test_torch_worker_pipelines.py, on four injected CPU devices): an
exception in one worker's batch surfaces from the Writer's write or close
(and from every later close), with every worker thread stopped; and
workers=1 keeps its one finishing thread, zseek-finish, with layout and
plans on the calling thread and no worker thread or zseek.worker span."""

import io
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from libzseek_tpu_torch.runtime.writer import Writer
from libzseek_tpu_torch.utils import device as udev
from libzseek_tpu_torch.utils import trace
from test_torch_worker_pipelines import make, write
from test_torch_workers import FOUR, K, mixed_512k, one_torch_thread


def worker_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("zseek-worker-")]


def test_worker_exception_surfaces_and_stops_every_worker(monkeypatch):
    monkeypatch.setattr(udev, "_visible_devices", lambda dev: FOUR)
    codec = make(4)
    real = codec._finish_blocks

    def planted(staged):
        if threading.current_thread().name == "zseek-worker-2":
            raise RuntimeError("planted in worker 2")
        return real(staged)

    codec._finish_blocks = planted
    data = mixed_512k()[: 7 * K]
    w = Writer(io.BytesIO(), codec=codec, min_frame_size=2 * K,
               batch_frames=2)
    with one_torch_thread(), pytest.raises(RuntimeError,
                                           match="planted in worker 2"):
        for pos in range(0, len(data), K):
            w.write(data[pos: pos + K])
        w.close()
    assert worker_threads() == []
    with pytest.raises(RuntimeError, match="planted in worker 2"):
        w.close()
    assert worker_threads() == []


def test_one_worker_starts_no_worker_thread():
    codec = make(1)
    assert codec._devices is None
    seen = set()
    real = codec._finish_blocks

    def hooked(staged):
        seen.update(t.name for t in threading.enumerate())
        seen.add("finishing: " + threading.current_thread().name)
        return real(staged)

    codec._finish_blocks = hooked
    trace.drain()
    with one_torch_thread(), profile(activities=[ProfilerActivity.CPU]):
        _, w = write(codec, mixed_512k()[: 7 * K])
    log = trace.drain()
    assert "finishing: zseek-finish_0" in seen
    assert not [n for n in seen if "zseek-worker" in n]
    assert w._stream.worker_batches == [] and w._stream._depth == 4
    caller = threading.current_thread().name
    assert {s.thread for s in log if s.name in ("zseek.layout", "zseek.plan",
                                                "zseek.dispatch")} == {caller}
    assert {s.thread for s in log if s.name == "zseek.finish"} == \
        {"zseek-finish_0"}
    assert not [s for s in log if s.name == "zseek.worker"]
