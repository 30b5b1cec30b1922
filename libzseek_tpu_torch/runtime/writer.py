"""Sequential archive writer.

Copy of libzseek_tpu/runtime/writer.py.  Chunk-coalescing semantics are
exact parity with the reference write path (src/compress.c:704-833 of
the reference library):

  * small writes buffer until the pending frame reaches min_frame_size, then
    the whole buffer becomes one frame (src/compress.c:717-729);
  * a write of >= min_frame_size arriving on an empty buffer becomes one
    frame directly, without copying into the coalescer (:710-714);
  * close() flushes the final partial frame, then appends the seek table
    (:396-455).

Unlike the reference — which compresses each frame synchronously on the
calling thread — completed frames are queued and compressed in device
batches (every block of a frame group is a row of one batched chain on
the card), then written to the sink in order.  The API contract (not
concurrency-safe, like src/zseek.h:278) is unchanged.  A codec given by
name is the port's ZstdCodec ("zstd", default level 3) or LZ4Codec
("lz4", default level 0) on `device`, given `workers` as the reference's
_make_codec gives it: zstd runs that many worker pipelines, one a device
where there are as many, and keeps two batches a worker in flight; LZ4's
batches round-robin over that many devices.
"""

from __future__ import annotations

from libzseek_tpu_torch.errors import ParameterError, ZseekError
from libzseek_tpu_torch.format import hints as H
from libzseek_tpu_torch.format.seek_table import FrameLog
from libzseek_tpu_torch.format.xxhash import xxh64
from libzseek_tpu_torch.runtime import io as zio
from libzseek_tpu_torch.runtime.stats import WriterStats
from libzseek_tpu_torch.utils import trace

DEFAULT_MIN_FRAME_SIZE = 1 << 20


def _make_codec(codec, level, device, workers: int = 1):
    if hasattr(codec, "compress_frames"):
        return codec
    if codec == "lz4":
        from libzseek_tpu_torch.runtime.codec import LZ4Codec
        return LZ4Codec(level=0 if level is None else level, device=device,
                        workers=workers)
    if codec == "zstd":
        from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
        return ZstdCodec(level=3 if level is None else level, device=device,
                         workers=workers)
    raise ParameterError(f"unknown codec {codec!r}")


class Writer:
    def __init__(self, sink, codec="zstd", *, level: int | None = None,
                 device: str = "cuda",
                 min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
                 batch_frames: int = 8, workers: int = 1,
                 checksums: bool = False, owned_file=None):
        if min_frame_size <= 0:
            raise ParameterError("min_frame_size must be positive")
        if not hasattr(sink, "write"):
            sink = zio.CallbackWriteSink(sink)
        self._sink = sink
        # file handle opened on the Writer's behalf (open_writer with a
        # path); closed by close() after the seek table lands
        self._owned_file = owned_file
        self._codec = _make_codec(codec, level, device, workers)
        self._min_frame_size = min_frame_size
        self._batch_frames = max(1, batch_frames)
        # per-frame seek-table checksums (low 32 bits of XXH64 of the
        # uncompressed frame, zstd seekable spec).  Off by default like the
        # reference (checksumFlag=0, src/compress.c:152)
        self._checksums = bool(checksums)
        self._framelog = FrameLog(checksum_flag=self._checksums)
        self._buffer = bytearray()
        self._queue: list[bytes] = []   # completed raw frames pending device
        self._closed = False
        self._stats = WriterStats()
        # decode-anchor hints (format/hints.py), collected per frame when
        # the codec produces them and published as a skippable sidecar
        # frame just before the seek table at close
        self._hints: list | None = \
            [] if getattr(self._codec, "supports_hints", False) else None
        # streaming session: keeps uploads / device batches / host assembly
        # overlapped across flush boundaries (codecs without begin_stream
        # compress synchronously per drained batch)
        self._stream = (self._codec.begin_stream(return_hints=True)
                        if hasattr(self._codec, "begin_stream") else None)
        self._stream_raw: list[list[bytes]] = []  # raw groups, FIFO

    # --- public API (zseek_write parity) ---

    def write(self, data) -> None:
        if self._closed:
            raise ZseekError("writer is closed")
        data = memoryview(data).cast("B")
        self._stats.decompressed_size += len(data)
        if not self._buffer and len(data) >= self._min_frame_size:
            # direct path: one frame, no coalescing copy
            self._enqueue_frame(bytes(data))
        else:
            self._buffer += data
            if len(self._buffer) >= self._min_frame_size:
                self._enqueue_frame(bytes(self._buffer))
                self._buffer.clear()
        self._stats.buffered_size = len(self._buffer)

    def flush(self) -> None:
        """Force-compress queued complete frames (not the partial buffer)."""
        self._drain_queue()
        if self._stream is not None:
            self._write_out(self._stream.finish())

    def close(self) -> WriterStats:
        """Flush the final partial frame, write the seek table, return final
        stats.  Idempotent."""
        if self._closed:
            return self._stats
        if self._buffer:
            self._enqueue_frame(bytes(self._buffer))
            self._buffer.clear()
        self._drain_queue()
        if self._stream is not None:
            self._write_out(self._stream.finish())
        if self._hints and any(any(b is not None for b in f)
                               for f in self._hints):
            blob = H.serialize(self._hints)
            self._put(blob)
            self._stats.sidecar_size = len(blob)
        self._put(self._framelog.serialize())
        self._closed = True
        self._refresh_stats()
        if self._owned_file is not None:
            self._owned_file.close()
        return self._stats

    def stats(self) -> WriterStats:
        self._refresh_stats()
        return self._stats

    # --- internals ---

    def _enqueue_frame(self, frame: bytes) -> None:
        self._queue.append(frame)
        if len(self._queue) >= self._batch_frames:
            self._drain_queue()

    def _drain_queue(self) -> None:
        if not self._queue:
            return
        frames, self._queue = self._queue, []
        if self._stream is not None:
            self._stream_raw.append(frames)
            self._write_out(self._stream.submit(frames))
            return
        if self._hints is not None:
            compressed, fhints = self._codec.compress_frames(
                frames, return_hints=True)
            self._hints.extend(fhints)
        else:
            compressed = self._codec.compress_frames(frames)
        for raw, comp in zip(frames, compressed):
            self._put(comp)
            self._framelog.log_frame(len(comp), len(raw),
                                     checksum=self._frame_checksum(raw))
            self._stats.compressed_size += len(comp)

    def _write_out(self, groups) -> None:
        """Write completed stream groups (in order) to the sink."""
        for compressed, fhints in groups:
            raw_frames = self._stream_raw.pop(0)
            if self._hints is not None:
                self._hints.extend(fhints)
            for raw, comp in zip(raw_frames, compressed):
                self._put(comp)
                self._framelog.log_frame(len(comp), len(raw),
                                         checksum=self._frame_checksum(raw))
                self._stats.compressed_size += len(comp)

    def _put(self, b) -> None:
        """One write to the user's sink."""
        with trace.span("zseek.sink"):
            self._sink.write(b)

    def _frame_checksum(self, raw: bytes) -> int:
        if not self._checksums:
            return 0
        return xxh64(raw) & 0xFFFFFFFF

    def _refresh_stats(self) -> None:
        st = self._stats
        st.seek_table_size = self._framelog.size()
        st.seek_table_memory = self._framelog.memory_usage()
        st.frames = len(self._framelog)
        st.buffered_size = len(self._buffer) + \
            sum(len(f) for f in self._queue) + \
            sum(len(f) for g in self._stream_raw for f in g)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._closed:
            self.close()
