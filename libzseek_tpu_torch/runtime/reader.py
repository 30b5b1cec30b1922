"""Random-access archive reader.

Copy of libzseek_tpu/runtime/reader.py around the port's codec.  Parity
with the reference read path (src/decompress.c of the reference library):

  * open sniffs the codec from the archive's first 4 bytes
    (ZSTD_MAGIC 0xFD2FB528 / LZ4_MAGIC 0x184D2204, :22-23,261-288) and
    decodes with the port's ZstdCodec or LZ4Codec on `device`;
  * the seek table is read from EOF via the pluggable pread/fsize callbacks;
  * pread(size, offset) binary-searches the covering frame, serves from the
    decompressed-frame LRU cache or decodes the frame (on the card) on a
    miss, and returns a short count at frame boundaries (:470-574) — callers
    loop, or use pread_full;
  * read() is the sequential cursor shim (:826-835), with the cursor
    update made atomic under the reader lock.

Reader-side concurrency: one lock guards the cursor and a second one the
cache (the reference has one rwlock, :38; the JAX reader one RLock for
both, and its read() can deadlock: it holds that lock while waiting on a
prefetch window whose worker needs it to insert the frames).  Frame decode
happens outside the locks so concurrent readers overlap device work
(double-checked cache insert, like the reference's rdlock->wrlock upgrade,
:484-553); two prefetch threads decode the next sequential windows, so
the codec is called from two threads at once.

`decoder` picks the zstd decode route (ZstdCodec): "auto" (the default)
takes the JAX package's routes, transcode for frames delivered to the
host (K4's transcode arm and the host executor, falling back to fused by
rule or after a failed stat) and fused for device-resident frames;
"fused" (K4) walks whole streams and skips the Writer's decode-anchor
sidecar, as stock zstd readers do; "lanes" is the lane decoders and K6.
"auto" and "lanes" load the sidecar, as the JAX reader does for every
zstd archive (_load_hints), and pass each frame's anchors to the codec.
LZ4 archives take "auto" only, the JAX package's routes: the native host
decoder for frames delivered to the host, the card's decoder for
device-resident frames (device_cache=True, or cache_frames=0).  `codec` (the reference's, :41)
replaces the sniffed codec with any object that has
decompress_frames(datas, d_sizes[, frame_hints][, to_device=True]); the
sidecar is loaded for it when it says supports_hints, and frames stay
on the device only when it says supports_device_frames.
prefetch(offsets) (the reference's, :154-186) decodes the uncached
frames covering a list of offsets in one codec call; it takes only the
cache lock.
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from libzseek_tpu_torch.errors import FormatError, ParameterError, ZseekError
from libzseek_tpu_torch.format.seek_table import SeekTable, parse_seek_table
from libzseek_tpu_torch.format.xxhash import xxh64
from libzseek_tpu_torch.runtime import io as zio
from libzseek_tpu_torch.runtime.cache import FrameCache
from libzseek_tpu_torch.runtime.stats import ReaderStats
from libzseek_tpu_torch.utils import trace

ZSTD_MAGIC = 0xFD2FB528
LZ4F_MAGIC = 0x184D2204
DEFAULT_CACHE_FRAMES = 8


class Reader:
    """Random-access reader of a zstd or LZ4 seekable archive (bytes, or a
    source with pread/fsize), decoding frames on `device` through the
    `decoder` route (K4's arms, the lane route or the LZ4 decoder on
    "cuda", LZ4 host delivery on the host; "cpu" runs the kernels' plain
    versions, for tests)."""

    def __init__(self, source, *, device="cuda",
                 cache_frames: int = DEFAULT_CACHE_FRAMES, codec=None,
                 readahead: int = 8, verify_checksums: bool = False,
                 device_cache: bool = False, decoder: str = "auto"):
        """device_cache=True keeps decompressed frames on the card (a
        device frame cache): cached entries are uint8 tensors and pread
        copies only the requested span to the host.  cache_frames=0 (no
        cache) also decodes onto the card and copies only the span, so
        host memory stays bounded by the request size — the analog of the
        reference's stream-and-discard no-cache path
        (src/decompress.c:377-468)."""
        if isinstance(source, (bytes, bytearray, memoryview)):
            source = zio.BytesIOSource(bytes(source))
        if not hasattr(source, "pread"):
            raise ParameterError("source must provide pread/fsize")
        self._src = source
        self._fsize = source.fsize()
        magic_bytes = source.pread(0, 4)
        if len(magic_bytes) < 4:
            raise FormatError("archive too small")
        magic = struct.unpack("<I", magic_bytes)[0]
        if codec is not None:
            if not hasattr(codec, "decompress_frames"):
                raise ParameterError("codec must provide decompress_frames")
            self._codec = codec
        elif magic == LZ4F_MAGIC:
            if decoder != "auto":
                raise ParameterError(
                    f"decoder {decoder!r}: LZ4 archives decode with 'auto'")
            from libzseek_tpu_torch.runtime.codec import LZ4Codec
            self._codec = LZ4Codec(device=device)
        elif magic == ZSTD_MAGIC:
            from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
            self._codec = ZstdCodec(device=device, decoder=decoder)
        else:
            raise FormatError(f"unknown archive magic 0x{magic:08X}")
        self._table: SeekTable = parse_seek_table(source.pread, self._fsize)
        # the Writer's decode anchors: the lane route anchors its walks at
        # them, the transcode route starts chunks mid-frame where they are
        wants = getattr(self._codec, "supports_hints", False) and \
            (codec is not None or decoder != "fused")
        self._hints = self._load_hints() if wants else None
        self._cache = FrameCache(cache_frames) if cache_frames > 0 else None
        self._lock = threading.Lock()          # the cursor
        self._cache_lock = threading.Lock()    # the cache
        self._pos = 0
        self._closed = False
        # sequential-miss readahead: consecutive frame misses batch the
        # next `readahead` frames into one device decode (frames are
        # chains of one batched kernel; per-frame calls waste the batch)
        self._readahead = max(1, readahead)
        self._last_miss = -2
        # async sequential prefetch: while the consumer drains window k,
        # background threads decode windows k+1 and k+2 into the cache
        self._ahead = deque()   # (start, end, future)
        self._pf_pool = None
        # opt-in verification of per-frame seek-table checksums (low 32
        # bits of XXH64 of the decompressed frame) when the table has them
        self._verify = bool(verify_checksums) and \
            self._table.checksums is not None
        # device-resident frames: opt-in via device_cache, and the default
        # for the no-cache path (bounded host memory)
        self._device_frames = (bool(device_cache) or cache_frames <= 0) \
            and getattr(self._codec, "supports_device_frames", False)

    # --- public API ---

    @property
    def seek_table(self) -> SeekTable:
        return self._table

    @property
    def decompressed_size(self) -> int:
        return self._table.decompressed_size

    def pread(self, size: int, offset: int) -> bytes:
        """Read up to `size` decompressed bytes at `offset`.  Like the
        reference, never crosses a frame boundary — returns a short count;
        b"" at or past EOF."""
        if self._closed:
            raise ZseekError("reader is closed")
        if size < 0 or offset < 0:
            raise ParameterError("negative size/offset")
        total = self._table.decompressed_size
        if offset >= total or size == 0:
            return b""
        idx = self._table.frame_for_offset(offset)
        in_off = offset - self._table.frame_d_offset(idx)
        with trace.span("zseek.pread"):
            if self._device_frames:
                return self._pread_span(idx, in_off, size)
            frame = self._get_frame(idx)
            return frame[in_off: in_off + size]

    def pread_full(self, size: int, offset: int) -> bytes:
        """Loop pread across frame boundaries (the caller-side loop of
        test/example.c:63-80, provided as a convenience)."""
        out = bytearray()
        while size > 0:
            chunk = self.pread(size, offset)
            if not chunk:
                break
            out += chunk
            size -= len(chunk)
            offset += len(chunk)
        return bytes(out)

    def read(self, size: int) -> bytes:
        """Sequential read at the internal cursor (zseek_read parity, with
        the cursor update done under the lock)."""
        with self._lock:
            data = self.pread(size, self._pos)
            self._pos += len(data)
            return data

    def seek(self, pos: int) -> None:
        with self._lock:
            self._pos = pos

    def prefetch(self, offsets) -> None:
        """Decode the frames covering `offsets` that are not cached into
        the cache, in one codec call (the batched analog of issuing N
        preads; the reference library has none)."""
        if self._closed:
            raise ZseekError("reader is closed")
        total = self._table.decompressed_size
        need = []
        for off in offsets:
            if not 0 <= off < total:
                continue
            idx = self._table.frame_for_offset(off)
            if idx in need:
                continue
            if self._cache is not None:
                with self._cache_lock:
                    if self._cache.find(idx, count=False) is not None:
                        continue
            need.append(idx)
        if not need:
            return
        frames = self._decode(need, to_device=self._device_frames)
        if self._cache is not None:
            with self._cache_lock:
                for i, fr in zip(need, frames):
                    if self._cache.find(i, count=False) is None:
                        self._cache.insert(i, fr)

    def close(self) -> ReaderStats:
        self._closed = True
        if self._pf_pool is not None:
            with trace.span("zseek.prefetch_wait"):
                self._pf_pool.shutdown(wait=True)
        return self.stats()

    def stats(self) -> ReaderStats:
        entry = 12 if self._table.checksums is not None else 8
        st = ReaderStats(
            seek_table_size=(8 + entry * self._table.num_frames + 9),
            seek_table_memory=self._table.memory_usage(),
            frames=self._table.num_frames,
            compressed_size=self._table.compressed_size,
            decompressed_size=self._table.decompressed_size,
        )
        if self._cache is not None:
            st.cache_memory = self._cache.memory_usage()
            st.cache_entries = self._cache.entries
            st.cache_hits = self._cache.hits
            st.cache_misses = self._cache.misses
        return st

    # --- internals ---

    def _decode(self, idxs: list[int], to_device: bool = False) -> list:
        """Read and decode frames `idxs` in one codec call; checks their
        seek-table checksums when asked to."""
        datas = [self._read_frame_bytes(i) for i in idxs]
        d_sizes = [self._table.frame_d_size(i) for i in idxs]
        args = () if self._hints is None else \
            ([self._frame_hints(i) for i in idxs],)
        kw = {"to_device": True} if to_device else {}
        frames = self._codec.decompress_frames(datas, d_sizes, *args, **kw)
        for i, fr in zip(idxs, frames):
            self._check_frame(i, fr)
        return frames

    def _load_hints(self):
        """Locate the decode-anchor sidecar (format/hints.py): a skippable
        frame immediately before the seek table, self-sized by its trailing
        u32.  Absent or foreign -> None (every frame takes plain lanes)."""
        from libzseek_tpu_torch.format import hints as H
        entry = 12 if self._table.checksums is not None else 8
        table_bytes = 8 + entry * self._table.num_frames + 9
        end = self._fsize - table_bytes
        if end < 16:
            return None
        tail = self._src.pread(end - 4, 4)
        if len(tail) != 4:
            return None
        total = int.from_bytes(tail, "little")
        if total < 16 or total > end:
            return None
        blob = self._src.pread(end - total, total)
        parsed = H.parse(blob, 0)
        if parsed is None or len(parsed) != self._table.num_frames:
            return None
        return parsed

    def _frame_hints(self, idx: int):
        return self._hints[idx] if self._hints is not None else None

    def _check_frame(self, idx: int, frame) -> None:
        if not self._verify:
            return
        if not isinstance(frame, (bytes, bytearray, memoryview)):
            frame = frame.cpu().numpy().tobytes()
        want = int(self._table.checksums[idx])
        got = xxh64(frame) & 0xFFFFFFFF
        if got != want:
            raise FormatError(
                f"frame {idx} checksum mismatch: {got:#010x} != "
                f"{want:#010x}")

    def _pread_span(self, idx: int, in_off: int, size: int) -> bytes:
        """Device-resident pread: the cache (if any) holds tensors on the
        card; only the requested span crosses to the host."""
        fr = None
        if self._cache is not None:
            with self._cache_lock:
                fr = self._cache.find(idx)
        if fr is None:
            fr = self._decode([idx], to_device=True)[0]
            if self._cache is not None:
                with self._cache_lock:
                    if self._cache.find(idx, count=False) is None:
                        self._cache.insert(idx, fr)
        n = min(size, int(fr.shape[0]) - in_off)
        return fr[in_off: in_off + n].cpu().numpy().tobytes()

    def _read_frame_bytes(self, idx: int) -> bytes:
        off = self._table.frame_c_offset(idx)
        size = self._table.frame_c_size(idx)
        with trace.span("zseek.source"):
            data = self._src.pread(off, size)
        if len(data) != size:
            raise FormatError(f"short read of frame {idx}")
        return data

    def _window(self) -> int:
        """Sequential decode window: half the cache holds the window being
        consumed, the other half the one being prefetched."""
        return min(self._readahead, max(1, self._cache.capacity // 2))

    def _depth(self) -> int:
        """Prefetch windows in flight: 2 when the cache can hold the
        consuming window plus both, else 1."""
        return 2 if self._cache.capacity >= 3 * self._window() else 1

    def _schedule_ahead(self, start: int, count: int, depth: int = 2)\
            -> None:
        """Queue up to `depth` prefetch windows of `count` frames starting
        at `start` (skipping any already queued)."""
        if self._cache is None or count <= 0:
            return
        if self._ahead:
            start = max(start, self._ahead[-1][1])
        if self._pf_pool is None:
            self._pf_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="zseek-prefetch")
        cause = trace.current()     # the read that queues the windows

        while len(self._ahead) < depth and start < self._table.num_frames:
            end = min(start + count, self._table.num_frames)
            idxs = list(range(start, end))

            def work(idxs=idxs):
                with trace.span("zseek.prefetch", cause):
                    frames = self._decode(idxs)
                    with self._cache_lock:
                        for i, fr in zip(idxs, frames):
                            if self._cache.find(i, count=False) is None:
                                self._cache.insert(i, fr)

            self._ahead.append((start, end, self._pf_pool.submit(work)))
            start = end

    def _get_frame(self, idx: int) -> bytes:
        if self._cache is not None:
            with self._cache_lock:
                hit = self._cache.find(idx)
            if hit is not None:
                return hit
        while self._ahead and self._ahead[0][1] <= idx:
            self._ahead.popleft()   # stale window (seek jumped past it)
        if self._ahead and self._ahead[0][0] <= idx < self._ahead[0][1]:
            # the prefetched window covers this frame: wait for it and
            # immediately pipeline the next window(s)
            s, e, fut = self._ahead.popleft()
            with trace.span("zseek.prefetch_wait"):
                fut.result()
            self._last_miss = e - 1
            self._schedule_ahead(e, self._window(), self._depth())
            with self._cache_lock:
                hit = self._cache.find(idx, count=False)
            if hit is not None:
                return hit
        # batch ahead on a sequential miss streak
        streak = idx == self._last_miss + 1
        self._last_miss = idx
        count = 1
        if streak and self._cache is not None:
            count = min(self._window(), self._table.num_frames - idx)
        idxs = [idx]
        for j in range(idx + 1, idx + count):
            with self._cache_lock:
                if self._cache is not None and \
                        self._cache.find(j, count=False) is not None:
                    break
            idxs.append(j)
        frames = self._decode(idxs)
        if self._cache is not None:
            with self._cache_lock:
                # double-checked: a concurrent reader may have inserted it
                for i, fr in zip(idxs, frames):
                    if self._cache.find(i, count=False) is None:
                        self._cache.insert(i, fr)
        # the streak continues at the window's end, and the next window
        # decodes in the background while this one is consumed
        self._last_miss = idxs[-1]
        if len(idxs) > 1 and not self._ahead:
            self._schedule_ahead(idxs[-1] + 1, self._window(),
                                 self._depth())
        return frames[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
