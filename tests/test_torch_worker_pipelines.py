"""The zstd stream's worker pipelines (`workers` > 1, libzseek's
nb_workers): worker threads zseek-worker-<i>, worker i on the (i mod n)-th
of the n visible devices, batch k on worker k mod W, each running its
batches' layout, device stages and finishing.  Here four workers on four
CPU devices injected through utils/device._visible_devices, and four on
the one CPU device.  Each worker's first batch waits at a barrier, so the
write finishes only if the four run at once; the archive equals
workers=1's byte for byte and decodes through the benchmark's plain
reference (zseek_bench/reference/).  Seven one-block batches make the
round-robin uneven: 2, 2, 2 and 1 batches."""

import io
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from libzseek_tpu_torch.runtime.writer import Writer
from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
from libzseek_tpu_torch.utils import device as udev
from libzseek_tpu_torch.utils import trace
from test_torch_workers import FOUR, K, mixed_512k, one_torch_thread
from zseek_bench.reference import archive as ref

NAMES = [f"zseek-worker-{i}" for i in range(4)]


def make(workers: int) -> ZstdCodec:
    return ZstdCodec(device="cpu", level=3, block=K, max_batch_blocks=1,
                     workers=workers)


def write(codec, data):
    """`data` through a Writer in 64 KiB writes, 128 KiB frames and two
    frames a submit; (archive, writer)."""
    buf = io.BytesIO()
    w = Writer(buf, codec=codec, min_frame_size=2 * K, batch_frames=2)
    for pos in range(0, len(data), K):
        w.write(data[pos: pos + K])
    w.close()
    return buf.getvalue(), w


def plain_decode(archive: bytes) -> bytes:
    return b"".join(ref.decode_frame(archive, off, c, "zstd")
                    for off, c, _ in ref.structure(archive, "zstd"))


def at_once(codec):
    """Hold each worker's first batch at a barrier of four; returns the
    devices each worker thread was handed, by thread name."""
    barrier = threading.Barrier(4, timeout=120)
    seen: dict[str, list] = {}
    real = codec._dispatch_parse

    def hooked(blocks, first_flags=None, dev=None):
        name = threading.current_thread().name
        if name not in seen:
            seen[name] = []
            barrier.wait()
        seen[name].append(dev)
        return real(blocks, first_flags=first_flags, dev=dev)

    codec._dispatch_parse = hooked
    return seen


def four_pipelines(devices, traced: bool = False):
    data = mixed_512k()[: 7 * K]
    with one_torch_thread():
        one, _ = write(make(1), data)
        codec = make(4)
        assert codec._devices == devices
        seen = at_once(codec)
        trace.drain()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                four, w = write(codec, data)
        else:
            four, w = write(codec, data)
    assert four == one
    assert plain_decode(four) == data
    assert sorted(seen) == NAMES
    for i, name in enumerate(NAMES):
        assert seen[name] == [devices[i]] * len(seen[name])
    assert w._stream.worker_batches == [2, 2, 2, 1] and codec._rr == 7
    assert w._stream._depth == 8
    assert not [t for t in threading.enumerate()
                if t.name.startswith("zseek-worker-")]
    return trace.drain()


def test_four_pipelines_on_four_devices(monkeypatch):
    """Worker i on device i; every batch's zseek.worker span on its
    worker's thread, caused by the calling thread's zseek.dispatch; the
    first four overlap; layout and plans run on the workers alone, the
    plans one at a time."""
    monkeypatch.setattr(udev, "_visible_devices", lambda dev: FOUR)
    log = four_pipelines(FOUR, traced=True)
    by_id = {s.id: s for s in log}
    work = sorted((s for s in log if s.name == "zseek.worker"),
                  key=lambda s: s.start_ns)
    assert [sum(s.thread == n for s in work) for n in NAMES] == [2, 2, 2, 1]
    for s in work:
        cause = by_id[s.cause]
        assert cause.name == "zseek.dispatch" and cause.thread == \
            threading.current_thread().name
    first = work[:4]
    assert max(s.start_ns for s in first) < min(s.end_ns for s in first)
    for name in ("zseek.layout", "zseek.plan"):
        threads = {s.thread for s in log if s.name == name}
        assert threads == set(NAMES), (name, threads)
    plans = sorted((s.start_ns, s.end_ns) for s in log
                   if s.name == "zseek.plan")
    assert len(plans) == 7
    assert all(a[1] <= b[0] for a, b in zip(plans, plans[1:]))


def test_four_pipelines_share_one_device():
    """With one visible device the four workers share it and still run at
    once, as libzstd's threads share cores."""
    cpu = torch.device("cpu")
    four_pipelines([cpu] * 4)
