"""The system under test, driven through the port's public Writer and
Reader alone: one driver per traffic `op`.  Each driver's `setup` builds
what the cell needs and warms the cell's own path once; `window` runs the
closed loop until `seconds` have passed (the operation in flight
finishes) and returns a Record of what it did and got back."""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np

from zseek_bench import traffic

INF = float("inf")


@dataclasses.dataclass
class Record:
    op: str
    window_s: float = 0.0
    attempted: int = 0          # calls into the port
    failed: int = 0             # calls that raised
    in_bytes: int = 0           # bytes given to Writer.write
    out_bytes: int = 0          # bytes the sink received
    read_bytes: int = 0         # bytes the reads returned
    call_s: list = dataclasses.field(default_factory=list)
    hits: int = 0               # ReaderStats over the window
    misses: int = 0
    archives: list = dataclasses.field(default_factory=list)  # kept Sinks
    dropped: int = 0            # archives of the window not kept
    answers: list = dataclasses.field(default_factory=list)  # (off, bytes)
    passes: list = dataclasses.field(default_factory=list)   # (parts, n)
    trace: object = None


class Sink:
    """The reference benchmark's counting sink, which also keeps the
    archive's parts for the comparison after the window."""

    def __init__(self):
        self.parts: list[bytes] = []
        self.n = 0

    def write(self, b) -> None:
        b = b if isinstance(b, bytes) else bytes(b)
        self.parts.append(b)
        self.n += len(b)

    def value(self) -> bytes:
        return b"".join(self.parts)


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def _failed(what: str) -> None:
    print(f"{what} raised:", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)


class _Driver:
    def __init__(self, config: dict, mix: dict, data: bytes, seed: int,
                 device: str):
        self.config, self.mix, self.data = config, mix, data
        self.seed, self.device = seed, device

    def writer(self, sink):
        from libzseek_tpu_torch import Writer
        c = self.config
        return Writer(sink, c["codec"], level=c["level"], device=self.device,
                      min_frame_size=c["min_frame_size"],
                      batch_frames=c["batch_frames"], workers=c["workers"],
                      checksums=c["checksums"])

    def reader(self, archive: bytes):
        from libzseek_tpu_torch import Reader
        r = self.config["reader"]
        return Reader(archive, device=self.device, decoder=r["decoder"],
                      cache_frames=r["cache_frames"],
                      readahead=r["readahead"],
                      device_cache=r["device_cache"])

    def write_archive(self, rec: Record | None = None) -> Sink:
        """The input through one Writer, in write_bytes calls and a close,
        into a new Sink; with `rec`, each call timed and counted there."""
        step = int(self.mix.get("write_bytes", 1 << 20))
        view = memoryview(self.data)
        sink = Sink()
        w = self.writer(sink)
        calls = [(w.write, view[p: p + step])
                 for p in range(0, len(view), step)] + [(w.close, None)]
        for i, (fn, arg) in enumerate(calls):
            t = time.perf_counter()
            try:
                fn() if arg is None else fn(arg)
            except Exception:
                if rec is None:
                    raise
                _failed("Writer")
                rec.attempted += len(calls) - i
                rec.failed += len(calls) - i
                rec.call_s += [INF] * (len(calls) - i)
                return sink
            if rec is not None:
                rec.call_s.append(time.perf_counter() - t)
                rec.attempted += 1
        if rec is not None:
            rec.in_bytes += len(view)
            rec.out_bytes += sink.n
        return sink

    def release(self) -> None:
        pass


class WriteDriver(_Driver):
    """Archives of the whole input back to back, each through a new
    Writer into a counting sink.  For the comparison the window keeps the
    bytes of its first archive and of each later one with odds KEEP,
    drawn from the seed; of the others it keeps the length alone, so that
    the window does not hold every archive it wrote in memory."""

    KEEP = 1 / 4

    def setup(self) -> None:
        self.write_archive()
        _sync(self.device)

    def window(self, seconds: float) -> Record:
        rec = Record("write")
        rng = np.random.default_rng([self.seed, 5])
        t0 = time.perf_counter()
        while True:
            sink = self.write_archive(rec)
            first = not rec.archives and not rec.dropped
            if first or rng.random() < self.KEEP:
                rec.archives.append(sink)
            else:
                rec.dropped += 1
            del sink            # a dropped archive goes before the next
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        rec.window_s = time.perf_counter() - t0
        return rec


class ScanDriver(_Driver):
    """Full sequential passes of read_bytes reads over the archive that
    set-up wrote, each pass on a fresh Reader (cold cache, both prefetch
    threads)."""

    KEEP = 1 / 8

    def setup(self) -> None:
        self.archive = self.write_archive().value()
        self._pass(None)
        _sync(self.device)

    def _pass(self, rec: Record | None, keep: bool = False) -> None:
        """One pass; with `rec`, counted there, and its bytes kept for the
        comparison when `keep` (the others are let go at once, so that
        the window's memory does not grow by a copy of every pass)."""
        step = int(self.mix["read_bytes"])
        r = self.reader(self.archive)
        parts, n = [], 0
        try:
            while True:
                try:
                    chunk = r.read(step)
                except Exception:
                    if rec is None:
                        raise
                    _failed("Reader.read")
                    rec.failed += 1
                    break
                finally:
                    if rec is not None:
                        rec.attempted += 1
                if not chunk:
                    break
                n += len(chunk)
                if keep:
                    parts.append(chunk)
        finally:
            r.close()
        if rec is not None:
            rec.passes.append((parts if keep else None, n))
            rec.read_bytes += n

    def window(self, seconds: float) -> Record:
        """Passes until `seconds` have passed; the first pass and each
        later one with odds KEEP, drawn from the seed, are compared."""
        rec = Record("scan")
        rng = np.random.default_rng([self.seed, 3])
        t0 = time.perf_counter()
        while True:
            self._pass(rec, keep=not rec.passes or rng.random() < self.KEEP)
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        rec.window_s = time.perf_counter() - t0
        return rec

    def release(self) -> None:
        self.archive = None


class PreadDriver(_Driver):
    """Random pread_full calls of read_bytes at uniform offsets, by one
    closed-loop client on one open Reader, on the calling thread (which
    the profiler sees)."""

    WARM = 256
    COUNT = 1 << 20     # offsets drawn (reused in turn past them)

    def setup(self) -> None:
        self.archive = self.write_archive().value()
        self.r = self.reader(self.archive)
        size = int(self.mix["read_bytes"])
        for off in traffic.offsets(self.mix, len(self.data), self.seed,
                                   self.WARM, stream=99).tolist():
            self.r.pread_full(size, off)
        self.offs = traffic.offsets(self.mix, len(self.data), self.seed,
                                    self.COUNT).tolist()
        _sync(self.device)

    def window(self, seconds: float) -> Record:
        rec = Record("pread")
        size = int(self.mix["read_bytes"])
        offs = self.offs
        before = self.r.stats()
        t0 = time.perf_counter()
        end = t0 + seconds
        i = 0
        while True:
            off = offs[i % len(offs)]
            i += 1
            t = time.perf_counter()
            try:
                b = self.r.pread_full(size, off)
            except Exception:
                _failed("Reader.pread_full")
                rec.failed += 1
                rec.call_s.append(INF)
            else:
                rec.call_s.append(time.perf_counter() - t)
                rec.answers.append((off, b))
            if time.perf_counter() >= end:
                break
        _sync(self.device)
        rec.window_s = time.perf_counter() - t0
        after = self.r.stats()
        rec.hits = after.cache_hits - before.cache_hits
        rec.misses = after.cache_misses - before.cache_misses
        rec.attempted = len(rec.call_s)
        rec.read_bytes = sum(len(b) for _, b in rec.answers)
        return rec

    def release(self) -> None:
        self.r.close()
        self.r = self.archive = self.offs = None


DRIVERS = {"write": WriteDriver, "scan": ScanDriver, "pread": PreadDriver}

