"""LZ4 frame codec on the GPU: LZ4F frames of 64 KiB blocks.

Counterpart of libzseek_tpu/runtime/codec.py LZ4Codec with its fused
parser (parser="auto" or "hash", the reference's device arm), its sort
parser (parser="sort", the reference's CPU default) and _LZ4Stream:

  host:   batch layout: for K5 (Bp+1, 64 KiB) with Bp = max(8, pow2)
          rows, row i+1 = block i and row i its context (shared, not
          duplicated), lengths and absolute min_ref fences (:175-226;
          here _layout_k5);
          for the sort parser (Bp, ctx + 64 KiB), each row its block
          behind a copy of its 64 KiB window (ctx = 0 for
          block_independent), min_ref where the frame's history starts
          (:226-242; here _layout_sort);
  device: K5 (ops/lz4_emit.py, csrc/lz4_emit.cu), or lz4_encode_blocks
          (ops/lz4_encode.py: the sort pipeline of ops/match.py with the
          greedy_select kernel, then the packing as PyTorch ops); then
          compact_payload of the payloads that beat their block's size;
  host:   one fetch of the lengths, bases and payload, the adaptive cap
          with its recompact/refetch path (_finish_batch, :245-278), and
          LZ4F assembly, storing a block raw from the host's bytes where
          its payload is not smaller (_assemble_frames, :128-148).

On a CUDA device each batch of a stream runs on a CUDA stream of its own
(_LZ4Stream keeps `depth` of them a device), from page-locked uploads to
a page-locked copy of its result, so the batches in flight run on the
card at once and the calling thread never waits for a kernel; the
finishing thread waits for each batch's own event.  K5 walks each frame
on one thread, so this is where the card's parallelism comes from.

Decoding takes the reference's routes (:288-299, 326-336): host
delivery goes through the native block decoder (zn_lz4_decode) on the
host, as the reference's does whenever its native library is there
(the port's is built at first use, so always); to_device=True runs the
card's LZ4 decoder (ops/lz4_decode.py, csrc/lz4_decode.cu), whose
frames stay on the device; device="cpu" runs its plain version.
`workers` is the reference's round-robin (its _put): with more than one
visible device, each batch is encoded on the next of the first
`workers` devices and finished there; decoding stays on the codec's
device.  Not ported: the ZN_LZ4_HOST_DECODE knob (A11 of ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import itertools
import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from libzseek_tpu_torch import native
from libzseek_tpu_torch.errors import FormatError, ParameterError
from libzseek_tpu_torch.format import lz4f
from libzseek_tpu_torch.ops.lz4_decode import lz4_decode_frames
from libzseek_tpu_torch.ops.lz4_emit import lz4_emit, out_cap
from libzseek_tpu_torch.ops.lz4_encode import lz4_encode_blocks
from libzseek_tpu_torch.ops.zstd_encode import compact_payload
from libzseek_tpu_torch.utils import trace
from libzseek_tpu_torch.utils.device import RoundRobin, resolve_device

BLOCK = 1 << 16  # 64 KiB blocks, like the reference writer
MAX_BATCH_BLOCKS = 128


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _on(stream):
    """The context that makes `stream` current on its device; nothing for
    None (a batch on the CPU)."""
    return contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)


class LZ4Codec(RoundRobin):
    """LZ4F frames with 64 KiB blocks, linked by default like the
    reference's LZ4F_compressFrame defaults.  Each row of a batch carries
    the previous block as its context, so matches reach across block
    boundaries; the batch cap of 128 rows keeps absolute positions within
    the 24 bits of K5's tagged table."""

    name = "lz4"
    supports_device_frames = True

    @staticmethod
    def _level_params(level: int) -> dict:
        """compression_level -> K5's search effort (the reference's LZ4F
        level semantics: level >= 3 engages LZ4HC there, so HC levels
        probe lazily and slow the miss accelerator)."""
        if level < 0:      # fast/acceleration arm
            return dict(lazy=0, accel_log=5)
        if level < 3:      # default
            return dict(lazy=0, accel_log=6)
        if level < 9:      # HC
            return dict(lazy=1, accel_log=8)
        return dict(lazy=2, accel_log=12)

    def __init__(self, level: int = 0,
                 max_batch_blocks: int = MAX_BATCH_BLOCKS,
                 block_independent: bool = False, parser: str = "auto",
                 device: str = "cuda", workers: int | None = None):
        if parser not in ("auto", "hash", "sort"):
            raise ParameterError(f"unknown LZ4 parser {parser!r}")
        if max_batch_blocks < 1:
            raise ParameterError("max_batch_blocks must be positive")
        self.level = level
        # the sort parser's candidate granularity
        self.seg_size = 8 if level < 0 else 4
        self.max_batch_blocks = min(max_batch_blocks, MAX_BATCH_BLOCKS)
        self.block_independent = block_independent
        self.parser = parser
        self.device = resolve_device(device)
        # N workers: batches round-robin over the first `workers` devices
        # (see ZstdCodec; blocks are independent, no collectives needed)
        self._init_workers(workers)
        # adaptive payload-fetch cap, sized from recent batches' realized
        # compressed bytes instead of the compress bound
        self._cap_hint: int | None = None
        self._needs = deque([1], maxlen=8)

    @staticmethod
    def _bucket_words(n: int) -> int:
        n = max(int(n), 1 << 12)
        e = max(0, n.bit_length() - 3)
        return ((n + (1 << e) - 1) >> e) << e

    def _cap_words_for(self, batch_words: int) -> int:
        if self._cap_hint is None:
            # first batch: the compress bound (an undershoot costs a
            # second fetch)
            return self._bucket_words(batch_words + (batch_words >> 8) +
                                      (1 << 12))
        return self._cap_hint

    # --- compress ---

    @staticmethod
    def _frame_spans(frames):
        spans = []  # (frame_idx, start, size)
        for fi, fr in enumerate(frames):
            n = len(fr)
            for s in range(0, n, BLOCK):
                spans.append((fi, s, min(BLOCK, n - s)))
        return spans

    def _assemble_frames(self, frames, spans, comp_payloads):
        """Per block choose compressed vs stored, build LZ4F containers."""
        out_frames = []
        cursor = 0
        for fi, fr in enumerate(frames):
            n = len(fr)
            nblocks = math.ceil(n / BLOCK) if n else 0
            blocks = []
            for _ in range(nblocks):
                fidx, s, sz = spans[cursor]
                assert fidx == fi
                payload = comp_payloads[cursor]
                cursor += 1
                if payload is None or len(payload) >= sz:
                    # incompressible: store raw from the host's bytes
                    blocks.append((bytes(fr[s: s + sz]), True))
                else:
                    blocks.append((payload, False))
            out_frames.append(lz4f.assemble_frame(
                blocks, n, block_independent=self.block_independent))
        return out_frames

    def begin_stream(self, return_hints: bool = False, depth: int = 4):
        """Streaming session with ZstdCodec.begin_stream's contract:
        submit(frames) returns completed older groups, finish() drains.
        LZ4 has no decode hints: each group is (frames, [None] * n)."""
        return _LZ4Stream(self, depth)

    def compress_frames(self, frames) -> list[bytes]:
        """Compress a list of frames; returns LZ4F container bytes per
        frame."""
        if not frames:
            return []
        stream = self.begin_stream()
        groups = stream.submit(frames) + stream.finish()
        out = []
        for fr_out, _ in groups:
            out.extend(fr_out)
        return out

    def _dispatch_batch(self, frames, chunk, ctx, streams):
        """Lay out one block batch, upload it and launch the encode (K5, or
        the sort parser), the compaction and the fetch of the result on
        the batch's device, with no wait on the card.  On a CUDA device
        all of it runs on the stream that streams(dev) gives, every upload
        is made from page-locked memory before the launch and the result
        lands in page-locked memory, and the event "done" fires when it
        is there; on the CPU there is no stream and no event."""
        B = len(chunk)
        Bp = max(8, 1 << max(0, (B - 1).bit_length()))
        dev = self._batch_device()
        stream = streams(dev) if dev.type == "cuda" else None
        sort = self.parser == "sort"
        with _on(stream):
            with trace.span("zseek.layout"):
                layout = self._layout_sort if sort else self._layout_k5
                rows, ints = layout(frames, chunk, ctx, Bp,
                                    stream is not None)
                sizes = ints[2].numpy().copy()
                rows, ints = (a.to(dev, non_blocking=True)
                              for a in (rows, ints))
            lens, min_ref, sizes_dev = ints
            if sort:
                out, olens = lz4_encode_blocks(rows, lens,
                                               seg_size=self.seg_size,
                                               ctx_len=ctx, min_ref=min_ref)
            else:
                out, olens = lz4_emit(rows, lens, min_ref, out_cap(BLOCK),
                                      **self._level_params(self.level))
            # blocks whose payload reaches the raw size are stored raw from
            # the host's bytes at assembly: their payloads stay out of the
            # fetch (the sort parser's padding rows report negative lengths)
            live = torch.where((olens >= 0) & (olens < sizes_dev), olens,
                               torch.zeros_like(olens))
            cap_words = self._cap_words_for(Bp * BLOCK // 4)
            dummy = torch.zeros((Bp, 1), dtype=torch.int32, device=dev)
            zb = torch.zeros((Bp,), dtype=torch.int32, device=dev)
            words = out.view(torch.int32)
            flat, base_w, _lw = compact_payload(words, live, dummy, zb,
                                                cap_words)
            meta = torch.cat([olens, base_w, flat])
            done = None
            if stream is not None:
                host = torch.empty(meta.shape, dtype=meta.dtype,
                                   pin_memory=True)
                meta = host.copy_(meta, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        return {"Bp": Bp, "sizes": sizes, "meta": meta, "done": done,
                "stream": stream, "cap_words": cap_words,
                "streams": (words, live)}

    @staticmethod
    def _layout_k5(frames, chunk, ctx, Bp, pinned):
        """K5's shared-context layout: (rows (Bp+1, 64 KiB) uint8, ints
        (3, Bp) int32 = lengths, absolute min_ref fences, block sizes), in
        page-locked memory where `pinned`.  The rows are not cleared first:
        each byte is written once, the bytes no block covers with zeros."""
        D = torch.empty((Bp + 1, BLOCK), dtype=torch.uint8,
                        pin_memory=pinned)
        ints = torch.zeros((3, Bp), dtype=torch.int32, pin_memory=pinned)
        d, (dlens, dminr, sizes) = D.numpy(), ints.numpy()
        dlens[:] = BLOCK
        # min_ref is an ABSOLUTE position (K5's table spans the rows):
        # row i's window starts at i * BLOCK
        dminr[:] = (np.arange(Bp, dtype=np.int32) + 1) * BLOCK
        fi0, s0, _ = chunk[0]
        if ctx and s0 > 0:
            d[0] = np.frombuffer(frames[fi0], np.uint8, BLOCK, s0 - BLOCK)
        else:
            d[0] = 0
        for i, (fi, s, sz) in enumerate(chunk):
            d[i + 1, :sz] = np.frombuffer(frames[fi], np.uint8, sz, s)
            d[i + 1, sz:] = 0
            dlens[i] = BLOCK + sz
            sizes[i] = sz
            if ctx and s > 0:
                dminr[i] = i * BLOCK  # previous row is same-frame
        d[len(chunk) + 1:] = 0
        return D, ints

    @staticmethod
    def _layout_sort(frames, chunk, ctx, Bp, pinned):
        """The sort parser's rows of ctx + 64 KiB, each block behind a copy
        of its window (the first block of a frame has none, so its min_ref
        is ctx): (rows (Bp, ctx + 64 KiB) uint8, ints (3, Bp) int32 =
        lengths, min_ref, block sizes), page-locked where `pinned`."""
        X = torch.zeros((Bp, ctx + BLOCK), dtype=torch.uint8,
                        pin_memory=pinned)
        ints = torch.zeros((3, Bp), dtype=torch.int32, pin_memory=pinned)
        x, (lens, min_ref, sizes) = X.numpy(), ints.numpy()
        for i, (fi, s, sz) in enumerate(chunk):
            x[i, ctx: ctx + sz] = np.frombuffer(frames[fi], np.uint8, sz, s)
            lens[i] = ctx + sz
            sizes[i] = sz
            if ctx:
                clen = min(BLOCK, s)  # the window this frame has
                if clen:
                    x[i, ctx - clen: ctx] = np.frombuffer(
                        frames[fi], np.uint8, clen, s - clen)
                min_ref[i] = ctx - clen
        return X, ints

    def _finish_batch(self, B, staged) -> list[bytes | None]:
        """Fetch one batch's results -> per-block payload bytes (None =
        store raw).  On a CUDA device the fetch waits for the batch's own
        event; a recompaction runs on the batch's stream."""
        Bp, sizes = staged["Bp"], staged["sizes"]
        with trace.span("zseek.fetch"):
            if staged["done"] is not None:
                staged["done"].synchronize()
            fetched = staged["meta"].cpu().numpy()
        olens = fetched[:Bp]
        base_w = fetched[Bp: 2 * Bp]
        live = np.where((olens >= 0) & (olens < sizes), olens, 0)
        need = int(base_w[Bp - 1]) + (int(live[-1]) + 3) // 4
        cap_words = staged["cap_words"]
        if need > cap_words:
            # the adaptive cap undershot: recompact at the exact bucket and
            # fetch again
            words, live_dev = staged["streams"]
            with _on(staged["stream"]):
                dummy = torch.zeros((Bp, 1), dtype=torch.int32,
                                    device=words.device)
                zb = torch.zeros((Bp,), dtype=torch.int32,
                                 device=words.device)
                flat_d, base_d, _lw = compact_payload(
                    words, live_dev, dummy, zb, self._bucket_words(need))
                with trace.span("zseek.fetch"):
                    flat = flat_d.cpu().numpy().view(np.uint8)
                    base_w = base_d.cpu().numpy()
        else:
            flat = fetched[2 * Bp:].view(np.uint8)
        self._needs.append(need)
        self._cap_hint = self._bucket_words(int(max(self._needs) * 1.4))
        return [None if olens[i] >= sizes[i] else
                flat[4 * int(base_w[i]): 4 * int(base_w[i]) +
                     int(olens[i])].tobytes() for i in range(B)]

    # --- decompress ---

    def decompress_frame(self, data: bytes, d_size: int) -> bytes:
        """Decode one LZ4F frame (linked or independent) of known
        decompressed size."""
        return self.decompress_frames([data], [d_size])[0]

    def _decompress_frames_host(self, datas, d_sizes) -> list[bytes]:
        """The reference's host route, taken for host delivery: each
        block through the native decoder (zn_lz4_decode) into the
        frame's buffer.  LZ4 has no entropy stage, so expanding bytes
        the host already holds is memcpy work; the card's decoder serves
        device-resident frames."""
        out = []
        with trace.span("zseek.host_decode"):
            for data, d in zip(datas, d_sizes):
                info = lz4f.parse_frame_header(data)
                blocks, _ = lz4f.parse_blocks(data, info, info.header_size)
                buf = np.empty(d, np.uint8)
                base = 0
                src = np.frombuffer(data, np.uint8)
                for blk in blocks:
                    if blk.uncompressed:
                        if base + blk.size > d:
                            raise FormatError("LZ4 frame overruns its size")
                        buf[base: base + blk.size] = \
                            src[blk.offset: blk.offset + blk.size]
                        base += blk.size
                    else:
                        lo = base if info.block_independent else 0
                        n = native.lz4_block_decode(
                            src[blk.offset: blk.offset + blk.size], buf,
                            base, lo)
                        if n < 0:
                            raise FormatError("corrupt LZ4 block")
                        base += n
                if base != d:
                    raise FormatError(
                        f"LZ4 frame regenerated {base} != declared {d}")
                out.append(buf.tobytes())
        return out

    def decompress_frames(self, datas, d_sizes, to_device: bool = False):
        """Decode a batch of LZ4F frames: host bytes per frame through the
        native host route, or with to_device=True one uint8 tensor per
        frame on the codec's device through the card's decoder, frames
        grouped by padded geometry, one decoder launch per group.  A
        corrupt frame raises FormatError."""
        if not to_device:
            return self._decompress_frames_host(datas, d_sizes)
        parsed = []
        for data in datas:
            info = lz4f.parse_frame_header(data)
            blocks, _ = lz4f.parse_blocks(data, info, info.header_size)
            parsed.append((info, blocks))
        results: list = [None] * len(datas)
        groups: dict[tuple, list[int]] = {}
        for i, ((info, blocks), d) in enumerate(zip(parsed, d_sizes)):
            K = max(1, len(blocks))
            Kp = 1 << max(0, (K - 1)).bit_length()
            M = _ceil_to(max((b.size for b in blocks), default=1), 1 << 12)
            F = _ceil_to(max(d, 1), BLOCK)
            key = (Kp, M, F, not info.block_independent)
            groups.setdefault(key, []).append(i)
        dev = self.device
        for (Kp, M, F, linked), idxs in groups.items():
            B = len(idxs)
            comp = np.zeros((B, Kp, M), np.uint8)
            clens = np.zeros((B, Kp), np.int32)
            unc = np.zeros((B, Kp), bool)
            for r, i in enumerate(idxs):
                _, blocks = parsed[i]
                for k, blk in enumerate(blocks):
                    comp[r, k, : blk.size] = np.frombuffer(
                        datas[i], np.uint8, blk.size, blk.offset)
                    clens[r, k] = blk.size
                    unc[r, k] = blk.uncompressed
            t = lambda a: torch.from_numpy(a).to(dev)
            out, out_lens, ok = lz4_decode_frames(t(comp), t(clens), t(unc),
                                                  F, linked=linked)
            out_lens = out_lens.cpu().numpy()
            ok = ok.cpu().numpy()
            for r, i in enumerate(idxs):
                if not ok[r]:
                    raise FormatError(f"corrupt LZ4 frame (index {i})")
                if out_lens[r] != d_sizes[i]:
                    raise FormatError(
                        f"LZ4 frame decoded to {out_lens[r]} bytes, "
                        f"expected {d_sizes[i]}")
                results[i] = out[r, : int(out_lens[r])]
        return results


class _LZ4Stream:
    """Streaming LZ4 compression session (see LZ4Codec.begin_stream),
    shaped like zstd_codec._ZstdStream: a single worker thread fetches and
    finishes batches in FIFO order while the caller's thread lays out and
    launches later ones; groups complete in submission order.  On a CUDA
    device the batches in flight run on the card at once: each on the next
    of its device's `depth` streams, the worker waiting on each batch's
    own event."""

    def __init__(self, codec: LZ4Codec, depth: int):
        self._codec = codec
        self._depth = max(1, depth)
        self._groups = deque()
        self._inflight = 0
        self._streams: dict = {}
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="zseek-lz4")

    def _stream_for(self, dev):
        """The next CUDA stream of `dev`'s `depth`, taken in turn."""
        ring = self._streams.get(dev)
        if ring is None:
            ring = self._streams[dev] = itertools.cycle(
                [torch.cuda.Stream(dev) for _ in range(self._depth)])
        return next(ring)

    def submit(self, frames):
        codec = self._codec
        frames = list(frames)
        ctx = 0 if codec.block_independent else BLOCK
        spans = codec._frame_spans(frames)
        g = {"frames": frames, "spans": spans, "batches": deque(),
             "payloads": {}}
        self._groups.append(g)
        for lo in range(0, len(spans), codec.max_batch_blocks):
            chunk = spans[lo: lo + codec.max_batch_blocks]
            with trace.span("zseek.dispatch"):
                st = codec._dispatch_batch(frames, chunk, ctx,
                                           self._stream_for)
                if trace.recording() and self._overlaps():
                    trace.mark("zseek.overlap")
                fut = self._pool.submit(self._finish, len(chunk), st,
                                        trace.current())
            g["batches"].append((lo, fut, st["done"]))
            self._inflight += 1
        return self._drain(self._depth)

    def _overlaps(self) -> bool:
        """Whether an earlier batch in flight still runs on the card (its
        event has not fired)."""
        return any(done is not None and not done.query()
                   for gr in self._groups for _, _, done in gr["batches"])

    def _finish(self, B, staged, cause):
        """One batch on the finishing thread, under the dispatch that
        queued it."""
        with trace.span("zseek.finish", cause):
            return self._codec._finish_batch(B, staged)

    def finish(self):
        out = self._drain(0)
        self._pool.shutdown(wait=True)
        return out

    def _drain(self, depth: int):
        codec = self._codec
        while self._inflight > depth:
            g = next(gr for gr in self._groups if gr["batches"])
            lo0, fut, _ = g["batches"].popleft()
            with trace.span("zseek.stream_wait"):
                got = fut.result()
            for i, payload in enumerate(got):
                g["payloads"][lo0 + i] = payload
            self._inflight -= 1
        done = []
        while self._groups and not self._groups[0]["batches"]:
            g = self._groups.popleft()
            payloads = [g["payloads"][i] for i in range(len(g["spans"]))]
            with trace.span("zseek.assemble"):
                out = codec._assemble_frames(g["frames"], g["spans"],
                                             payloads)
            done.append((out, [None] * len(g["frames"])))
        return done
