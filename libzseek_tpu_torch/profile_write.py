"""Where one write of the port's main path, and one read of what it
wrote, spend their time on the GPU.

    python -m libzseek_tpu_torch.profile_write [zstd|zstd9|lz4|hash|transcode|lanes]

Writes 64 MiB of mixed_corpus(seed 11) through the port's Writer with
the codec named (zstd, the default, at level 3; zstd9, zstd at level 9
with its 64 KiB blocks and K1's level >= 4 arms; lz4 at level 0; hash,
ZstdCodec(parser="hash") at level 3; transcode and lanes, zstd at level
3; 1 MiB frames, batch_frames=16, 1 MiB writes), once to warm up
and once under torch.profiler with CPU and CUDA activities; then reads
the archive back through the port's Reader(device="cuda",
decoder="fused") in 1 MiB reads (K4's execute arm; transcode:
Reader(decoder="auto"), whose host delivery takes K4's transcode arm;
lanes: Reader(decoder="lanes"), K6 on every batch; lz4:
Reader(decoder="auto"), the native host route),
likewise once to warm up
and once profiled.  For each, prints
the wall time, the device's busy share of it (union of CUDA kernel and
copy intervals), the CUDA time per kernel name, the host time inside
each stage range (`zseek.*`) of the calling thread as the profiler saw
it, and the time and self time of each stage on every thread from the
port's span log (utils/trace.py: the write's finishing thread and the
read's prefetch threads too), after the card's name and power limit.
Needs a CUDA device.  Counterpart in the JAX package: the ZN_PROFILE
stage marks of libzseek_tpu/runtime/zstd_codec.py (_dispatch_parse,
_finish_chain) and ops/zstd_decode.py (decode_frames).
"""

from __future__ import annotations

import functools
import io
import subprocess
import sys
import time

MIB = 1 << 20
SIZE_MIB = 64    # the main path's write (bench.py, chip_smoke.py)


# codec argument -> (Writer codec, level)
CODECS = {"zstd": ("zstd", None), "zstd9": ("zstd", 9), "lz4": ("lz4", None),
          "hash": ("hash", None), "transcode": ("zstd", None),
          "lanes": ("zstd", None)}


def _write(data: bytes, codec: str = "zstd") -> bytes:
    import torch
    from libzseek_tpu_torch import Writer, ZstdCodec
    codec, level = CODECS[codec]
    if codec == "hash":
        codec = ZstdCodec(device="cuda", parser="hash")
    sink = io.BytesIO()
    w = Writer(sink, codec, level=level, device="cuda", min_frame_size=MIB,
               batch_frames=16)
    for pos in range(0, len(data), MIB):
        w.write(data[pos: pos + MIB])
    w.close()
    torch.cuda.synchronize()
    return sink.getvalue()


def _read(archive: bytes, decoder: str = "fused") -> bytes:
    import torch
    from libzseek_tpu_torch import Reader
    parts = []
    with Reader(archive, device="cuda", decoder=decoder) as r:
        while chunk := r.read(MIB):
            parts.append(chunk)
    torch.cuda.synchronize()
    return b"".join(parts)


def _profiled(fn, arg):
    """fn(arg) once to warm up, then once under the profiler: (result of
    the profiled call, profile, wall seconds, span log)."""
    from torch.profiler import ProfilerActivity, profile
    from libzseek_tpu_torch.utils import trace
    fn(arg)
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn(arg)
        wall = time.perf_counter() - t0
    return out, prof, wall, trace.drain()


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def report(prof, wall: float, log=()) -> None:
    """Print the device's busy share of `wall` seconds (union of CUDA
    kernel and copy intervals), the CUDA time per kernel name, the host
    time inside each `zseek.*` stage range of a profile and, from the
    span log, each stage's time and self time by thread."""
    from torch.autograd import DeviceType
    # kernels and copies; the zseek.* ranges also appear on the device
    # timeline as annotations and are left out
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA
           and not e.name.startswith("zseek.")]
    busy_s = _union_us(dev) / 1e6
    kernels, stages = {}, {}
    for a in prof.key_averages():
        dt = getattr(a, "device_time_total", 0) or 0
        if dt and a.device_type == DeviceType.CUDA and \
                not a.key.startswith("zseek."):
            kernels[a.key] = (dt / 1e3, a.count)
    for e in prof.events():
        if e.name.startswith("zseek.") and e.device_type == DeviceType.CPU:
            ms, n = stages.get(e.name, (0.0, 0))
            stages[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if dev:
        print(f"device busy {busy_s:.3f} s = {100 * busy_s / wall:.1f} % of "
              f"the wall time (idle {100 * (1 - busy_s / wall):.1f} %)")
    else:
        print("device time not measured: the profiler saw no CUDA events")
    print("CUDA time by kernel (ms, launches):")
    for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:10.3f} {n:6d}  {k[:70]}")
    print("host time inside stages, calling thread (ms, calls):")
    for k, (ms, n) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} {n:6d}  {k}")
    from libzseek_tpu_torch.utils import trace
    own = trace.self_ns(log)
    by = {}
    for s in log:
        key = (s.thread.rsplit("_", 1)[0], s.name)
        ms, self_ms, n = by.get(key, (0.0, 0.0, 0))
        by[key] = (ms + (s.end_ns - s.start_ns) / 1e6,
                   self_ms + own[s.id] / 1e6, n + 1)
    print("span log, every thread (ms, self ms, spans):")
    for (th, k), (ms, self_ms, n) in sorted(by.items(),
                                            key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} {self_ms:10.3f} {n:6d}  {th:16s} {k}")


def main(argv: list[str]) -> int:
    import numpy as np
    import torch
    from libzseek_tpu_torch.testing.corpus import mixed_corpus
    codec = argv[0] if argv else "zstd"
    if codec not in CODECS or len(argv) > 1:
        print("usage: python -m libzseek_tpu_torch.profile_write "
              f"[{'|'.join(CODECS)}]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    data = mixed_corpus(np.random.default_rng(11), SIZE_MIB * MIB).tobytes()
    archive, prof, wall, log = _profiled(
        functools.partial(_write, codec=codec), data)
    print(f"{codec} write {SIZE_MIB} MiB: {wall:.3f} s = "
          f"{SIZE_MIB / wall:.2f} MiB/s,"
          f" ratio {len(archive) / len(data):.5f}")
    report(prof, wall, log)
    decoder = {"transcode": "auto", "lz4": "auto",
               "lanes": "lanes"}.get(codec, "fused")
    got, prof, wall, log = _profiled(
        functools.partial(_read, decoder=decoder), archive)
    if got != data:
        print("the read differs from the input", file=sys.stderr)
        return 1
    print(f"{codec} read {SIZE_MIB} MiB: {wall:.3f} s = "
          f"{SIZE_MIB / wall:.2f} MiB/s")
    report(prof, wall, log)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
