"""zstd seekable-frame codec on the GPU: the write path at every level
and the read path.

Counterpart of libzseek_tpu/runtime/zstd_codec.py ZstdCodec with its
`parser` ("auto" = "linked", "linked", "hash", "sort"), `entropy`
("auto", "smem", "xla"), `max_batch_blocks`, `collect_hints` and
`workers` keywords (:119-181).  The level picks K1's search arms
(ops/zstd_encode.level_search_params), the sort parser's segment size
and extension length (:136-137), and the block size: 64 KiB from level 4
up, 128 KiB below (:140-148), for every parser.  At 64 KiB K3 is
off and K2 emits every literal payload.  The device chain
(parser="linked", entropy "auto" or "smem"):

  host:   batch layout (Bp+1, N) with Bp = max(8, pow2) rows, row r+1 =
          block r and row r its context, min_abs frame fences, and the
          native long-distance pre-pass (_dispatch_parse, :258-353);
  device: block_entropy_h16 -> K1 linked parse -> _linked_post ->
          Huffman plan + sequence-table plan -> K2 entropy emission, with
          K3 taking the literal payload of literal-heavy 4-stream rows ->
          compact_payload (_dispatch_chain, :422-509);
  host:   one fetch of the small per-block results and the payload, the
          adaptive payload cap with its recompact/refetch path, Huffman
          tree serialization and frame assembly (_finish_chain, :511;
          _assemble, :1039; _assemble_frames, :216).

The per-block path (parser="hash" or "sort", or entropy="xla" with any
parser):

  host:   batch layout (Bp, N), no context row, and the long-distance
          pre-pass (:354-394);
  device: K7 hash parse -> gate and recompaction (_fast_post, with the
          literal plane when the XLA arm is asked for) (:375-382), or the
          sort parser (zstd_sequences over ops/match.py: a batched sort,
          the gate, the greedy_select kernel, run merging; always with
          the literal plane, so entropy="auto" takes the XLA arm, as in
          the reference) (:302-305);
  host:   the small per-block results, Huffman tables per block (native
          huf_build_batch) and literal-mode decisions (_finish_blocks,
          _decide_modes, :641-791);
  device: K2 with host-built codes and predefined sequence tables
          (_entropy_smem, :819) or, when a block of the batch holds more
          than SMEM_SEQ_MAX sequences, the XLA arm: literal extraction,
          4-stream Huffman and FSE as torch ops with a host state walk
          (_entropy_xla, :911; ops/xla_entropy.py); compaction;
  host:   one fetch, the exact Huffman-to-raw fallback of the XLA arm,
          and assembly with all-predefined sequence tables.

The host assembly helpers are copies of the reference's (they sit in a
module that imports JAX); the byte-identity tests hold them to it.  The
reference's ZN_* environment knobs are not ported (their defaults are
fixed), nor its adaptive vector-literal hint: every row K3 accepts goes
through K3, with identical bits either way.  `workers` is the
reference's round-robin: with more than one visible device, each batch
goes to the next of the first `workers` devices (utils/device.py), and
its upload, device stages and finishing follow it there.
collect_hints=False returns no decode hints (the archive bytes are the
same).

Decoding (decompress_frames, the Reader's codec call) takes the routes
of the reference's decode_frames (ops/zstd_decode.py), chosen by
`decoder`: "auto" (the default) is the reference's choice (its
:1298-1321): host delivery takes the transcode route (Huffman literals
on the host, K4's transcode arm on the device, sequence execution on the
host; decode_frames_transcode), which hands a batch to fused by rule
(its predicted block sizes do not add up) or after a failed stat, both
counted in zstd_decode.routes; device delivery (to_device=True) goes
straight to fused.  The reference's third rung, its XLA lane passes for
blocks its fused packer refuses, has no counterpart: the port's fused
route takes those blocks too, with the same bytes.  "auto" takes the
reference's accelerator branch on every device, device="cpu" included.
"fused" is host frame parse and row packing, then K4 on the device
(ops/decode.py), for both deliveries; "lanes" is the route the
reference runs with ZN_DECODE_SMEM=off: Huffman and FSE lane decoders,
anchored at the Writer's decode hints where a frame has them
(ops/lanes.py), then K6 (ops/exec_blocks.py) or the pointer-doubling
executor.
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from libzseek_tpu_torch import native
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.format import hints
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import fse
from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import fse_plan as fpl
from libzseek_tpu_torch.ops import huffman_plan as hp
from libzseek_tpu_torch.ops import vector_entropy as VE
from libzseek_tpu_torch.ops import xla_entropy as XE
from libzseek_tpu_torch.ops import zstd_decode
from libzseek_tpu_torch.ops.parse_linked import CAP
from libzseek_tpu_torch.ops.zstd_encode import (apply_ldm_override,
                                                compact_payload,
                                                extract_literals,
                                                ldm_literal_plane,
                                                ldm_literal_stats,
                                                zstd_sequences,
                                                zstd_sequences_fast,
                                                zstd_sequences_fast_nolit,
                                                zstd_sequences_linked)
from libzseek_tpu_torch.utils import trace
from libzseek_tpu_torch.utils.device import RoundRobin, resolve_device

BLOCK = zf.BLOCK_MAX          # 128 KiB, the format's largest block
BLOCK_HIGH = 1 << 16          # the block of levels >= 4
MIN_BLOCK = 4096
LDM_MIN_DIST = 1 << 17        # long-distance matches beyond the window
MAX_BATCH_BLOCKS = 64         # blocks per device batch, by default
LIT_ANCHOR_INTERVAL = E.LIT_ANCHOR_INTERVAL
SEQ_ANCHOR_INTERVAL = E.SEQ_ANCHOR_INTERVAL
SMEM_SEQ_MAX = 4096   # beyond this many sequences in a block: the XLA arm
SMEM_SEQ_MIN = 512    # lower bound on K2's sequence bucket
PARSERS = ("linked", "hash", "sort")
ENTROPIES = ("auto", "smem", "xla")
DECODERS = ("auto", "fused", "lanes")


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _lit_section_raw(lits: bytes) -> bytes:
    n = len(lits)
    if n < 32:
        head = bytes([(n << 3) | zf.LIT_RAW])
    elif n < 4096:
        head = bytes([((n & 0xF) << 4) | (0b01 << 2) | zf.LIT_RAW, n >> 4])
    else:
        head = bytes([((n & 0xF) << 4) | (0b11 << 2) | zf.LIT_RAW,
                      (n >> 4) & 0xFF, n >> 12])
    return head + lits


def _lit_section_rle(byte: int, n: int) -> bytes:
    if n < 32:
        head = bytes([(n << 3) | zf.LIT_RLE])
    elif n < 4096:
        head = bytes([((n & 0xF) << 4) | (0b01 << 2) | zf.LIT_RLE, n >> 4])
    else:
        head = bytes([((n & 0xF) << 4) | (0b11 << 2) | zf.LIT_RLE,
                      (n >> 4) & 0xFF, n >> 12])
    return head + bytes([byte])


def _lit_section_huff1(regen: int, comp: int, payload: bytes) -> bytes:
    """Single-stream compressed literals header (Size_Format 00)."""
    v = zf.LIT_COMPRESSED | (0b00 << 2) | (regen << 4) | (comp << 14)
    return v.to_bytes(3, "little") + payload


def _lit_section_huff(regen: int, comp: int, payload: bytes) -> bytes:
    """4-stream compressed literals header (Size_Format 01/10/11)."""
    if regen <= 1023 and comp <= 1023:
        v = zf.LIT_COMPRESSED | (0b01 << 2) | (regen << 4) | (comp << 14)
        return v.to_bytes(3, "little") + payload
    if regen <= 16383 and comp <= 16383:
        v = zf.LIT_COMPRESSED | (0b10 << 2) | (regen << 4) | (comp << 18)
        return v.to_bytes(4, "little") + payload
    v = zf.LIT_COMPRESSED | (0b11 << 2) | (regen << 4) | (comp << 22)
    return v.to_bytes(5, "little") + payload


def _nbseq_header(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([(n >> 8) + 128, n & 0xFF])
    return bytes([255]) + (n - 0x7F00).to_bytes(2, "little")


_MODE_NAMES = {hp.M_SKIP: "skip", hp.M_RLEBLOCK: "rleblock",
               hp.M_NONE: "none", hp.M_RLE: "rle", hp.M_RAW: "raw",
               hp.M_HUF: "huf", hp.M_HUF1: "huf1"}


class ZstdCodec(RoundRobin):
    """zstd seekable-frame codec: compression and decompression on the
    GPU (or, with device="cpu", through every kernel's plain version, for
    tests).  Compression also yields per-block decode anchors
    (format/hints.py) that the Writer publishes in a skippable sidecar
    frame."""

    name = "zstd"
    supports_hints = True
    supports_device_frames = True

    def __init__(self, level: int = 3, device: str = "cuda",
                 block: int | None = None, parser: str = "auto",
                 entropy: str = "auto", decoder: str = "auto",
                 max_batch_blocks: int = MAX_BATCH_BLOCKS,
                 collect_hints: bool = True, workers: int | None = None):
        parser = "linked" if parser == "auto" else parser
        if parser not in PARSERS:
            raise ParameterError(f"unknown parser {parser!r}: one of "
                                 f"'auto', {', '.join(map(repr, PARSERS))}")
        if entropy not in ENTROPIES:
            raise ParameterError(f"unknown entropy {entropy!r}: one of "
                                 f"{', '.join(map(repr, ENTROPIES))}")
        if decoder not in DECODERS:
            raise ParameterError(f"unknown decoder {decoder!r}: one of "
                                 f"{', '.join(map(repr, DECODERS))}")
        # levels >= 4 halve the block: twice the sequence slots per byte
        # for the 8192-slot parse cap; an explicit block (the reference's
        # ZN_BLOCK) wins at every level
        if block is None:
            block = BLOCK_HIGH if level >= 4 else BLOCK
        if block & (block - 1) or not MIN_BLOCK <= block <= BLOCK:
            raise ParameterError(
                f"block size {block}: must be a power of two in "
                f"[{MIN_BLOCK}, {BLOCK}]")
        if max_batch_blocks < 1:
            raise ParameterError("max_batch_blocks must be positive")
        rows = max(8, 1 << (max_batch_blocks - 1).bit_length()) + 1
        if parser == "linked" and rows * block > 1 << 24:
            # K1's table entries hold 24-bit positions over the batch
            raise ParameterError(
                f"max_batch_blocks {max_batch_blocks}: the linked parser "
                f"takes at most {(1 << 24) // block - 1} blocks of {block} "
                f"bytes a batch (rounded up to a power of two)")
        self.level = level
        self.device = resolve_device(device)
        # N workers: batches round-robin over the first `workers` devices;
        # frames are independent, so the batches need no collectives
        self._init_workers(workers)
        self.block = block
        self.max_batch_blocks = max_batch_blocks
        self.collect_hints = collect_hints
        # "linked": K1 across each frame's blocks, the device chain;
        # "hash": K7 on every block alone, the per-block path; "sort": the
        # exact sort pipeline on every block alone, the per-block path
        self.parser = parser
        # the sort parser's candidate granularity and extension length
        self.seg_size = 8 if level <= 1 else 4
        self.max_len = 32 if level <= 1 else 48
        # "auto"/"smem": K2 (the chain, or the per-block path's K2 arm while
        # its blocks hold <= SMEM_SEQ_MAX sequences); "xla": the XLA arm
        self.entropy = entropy
        # "auto": transcode (K4's transcode arm and the host executor;
        # hints allow mid-frame chunks) for host delivery, fused for device
        # delivery (the reference's choice); "fused": K4 walks whole
        # streams; "lanes": the lane route, which reads the Writer's hints
        self.decoder = decoder
        # adaptive payload-fetch cap, sized from recent batches
        self._cap_hint: int | None = None
        self._needs = deque([1], maxlen=8)

    # --- compress ---

    def compress_frames(self, frames, return_hints: bool = False):
        stream = self.begin_stream()
        groups = stream.submit(frames) + stream.finish()
        out, out_hints = [], []
        for fr_out, fh in groups:
            out.extend(fr_out)
            out_hints.extend(fh)
        return (out, out_hints) if return_hints else out

    def begin_stream(self, return_hints: bool = True, depth: int = 4):
        """Streaming session: `submit(frames)` dispatches a frame group and
        returns older (frames, hints) groups that completed, `finish()`
        drains the rest; groups complete in submission order.  Hints are
        always returned; `return_hints` is the shared Writer's keyword."""
        return _ZstdStream(self, depth)

    def _frame_spans(self, frames):
        spans = []
        for fi, fr in enumerate(frames):
            n = len(fr)
            for s in range(0, n, self.block):
                spans.append((fi, s, min(self.block, n - s)))
        return spans

    def _assemble_frames(self, frames, spans, block_payloads, block_hints):
        out = []
        out_hints = []
        cursor = 0
        for fi, fr in enumerate(frames):
            n = len(fr)
            body = bytearray(zf.build_frame_header(n, single_segment=True))
            fhints = []
            nblocks = math.ceil(n / self.block)
            if n == 0:
                body += zf.build_block_header(zf.BLOCK_RAW, 0, last=True)
                fhints.append(None)
            for b in range(nblocks):
                fi2, s, sz = spans[cursor]
                assert fi2 == fi
                payload = block_payloads[cursor]
                bh = block_hints[cursor]
                cursor += 1
                last = b == nblocks - 1
                if isinstance(payload, tuple):   # ("rle", byte)
                    body += zf.build_block_header(zf.BLOCK_RLE, sz, last)
                    body += bytes([payload[1]])
                    fhints.append(None)
                elif payload is None or len(payload) >= sz:
                    body += zf.build_block_header(zf.BLOCK_RAW, sz, last)
                    body += bytes(fr[s: s + sz])
                    fhints.append(None)
                else:
                    body += zf.build_block_header(
                        zf.BLOCK_COMPRESSED, len(payload), last)
                    body += payload
                    fhints.append(bh)
            out.append(bytes(body))
            out_hints.append(fhints)
        return out, out_hints

    def _dispatch_parse(self, blocks: list[np.ndarray],
                        first_flags: list[bool] | None = None):
        """Upload one batch to its device and dispatch its device stages
        there.  first_flags[i] marks a frame's first block; the linked
        parser fences frame starts and the batch start off from the
        preceding row (min_abs)."""
        linked = self.parser == "linked"
        with trace.span("zseek.layout"):
            X, lens, min_abs, ldm, lens_parse = self._layout(
                blocks, first_flags, linked)
        dev = self._batch_device()
        t = lambda a: torch.from_numpy(a).to(dev)
        B = len(blocks)
        X2d = t(X)
        if linked:
            seqs = zstd_sequences_linked(
                X2d, t(lens), t(min_abs), level=self.level,
                parse_lengths=None if lens_parse is None else t(lens_parse))
            X2d = X2d[1:]
        elif self.parser == "sort":
            with trace.span("zseek.parse"):
                seqs = zstd_sequences(X2d, t(lens), seg_size=self.seg_size,
                                      max_len=self.max_len)
        elif self.entropy == "xla":
            seqs = zstd_sequences_fast(X2d, t(lens))
        else:
            seqs = zstd_sequences_fast_nolit(X2d, t(lens))
        if ldm is not None:
            plane = ldm_literal_plane(ldm[0], blocks, len(lens), self.block) \
                if "literals" in seqs else None
            seqs = apply_ldm_override(seqs, ldm[0], lens, ldm[1], plane)
        if linked and self.entropy != "xla":
            return self._dispatch_chain(seqs, lens[:B], X2d, lens, dev)
        packed = torch.cat([seqs["hist"].reshape(-1), seqs["lit_count"],
                            seqs["n_seq"], seqs["const"]]).to(torch.int32)
        return {"kind": "blocks", "seqs": seqs, "lens": lens[:B],
                "x": X2d, "lens_pad": lens, "packed": packed}

    def _layout(self, blocks, first_flags, linked: bool = True):
        """Host batch layout: Bp = max(8, pow2) rows of N bytes, block r in
        row r+1 below a context row when `linked`, else in row r;
        lengths, min_abs fences, and the native long-distance pre-pass."""
        B = len(blocks)
        Bp = max(8, 1 << max(0, (B - 1).bit_length()))
        N = self.block
        off = 1 if linked else 0
        X = np.zeros((Bp + off, N), np.uint8)
        lens = np.zeros((Bp,), np.int32)
        min_abs = np.zeros((Bp,), np.int32)
        frame_base = np.full((Bp,), -1, np.int64)
        fb = 0
        for i, blk in enumerate(blocks):
            X[i + off, : len(blk)] = blk
            lens[i] = len(blk)
            first = (first_flags is None or first_flags[i] or i == 0
                     or len(blocks[i - 1]) < N)
            min_abs[i] = (i + 1) * N if first else i * N
            if first:
                fb = i * N
            frame_base[i] = fb
        for i in range(B, Bp):
            min_abs[i] = (i + 1) * N
        # long-distance pre-pass (host, native): whole-block matches beyond
        # the parse's window become single long-match sequences; with the
        # linked parser covered rows skip the parse, except the last of
        # each run, which keeps the hash table warm for the next block
        ldm = None
        lens_parse = None
        d = native.ldm_scan(X[off: B + off].reshape(-1), B, N,
                            frame_base[:B], lens[:B], LDM_MIN_DIST)
        if (d[:, 0] > 0).any():
            ldm = ldm_literal_stats(d, blocks, Bp)
            cov = d[:, 0] > 0
            skip = cov.copy()
            skip[:-1] = cov[:-1] & cov[1:]
            if linked and skip.any():
                lens_parse = lens.copy()
                lens_parse[:B][skip] = 0
        return X, lens, min_abs, ldm, lens_parse

    @staticmethod
    def _bucket_words(n: int) -> int:
        """Round a word count up to 2 mantissa bits (<= 25 % overshoot)."""
        n = max(int(n), 1 << 14)
        e = max(0, n.bit_length() - 3)
        return ((n + (1 << e) - 1) >> e) << e

    def _cap_words_for(self, batch_words: int) -> int:
        if self._cap_hint is None:
            # first batch: assume ratio <= 0.5 + slack; the overflow
            # refetch path covers harder data
            return self._bucket_words(batch_words // 2 + (1 << 14))
        return self._cap_hint

    def _dispatch_chain(self, seqs, lens, x_dev, lens_pad, dev):
        Bp = seqs["n_seq"].shape[0]
        N = self.block
        S = seqs["ll"].shape[1]
        lit_cap = _ceil_to(N + 64, 128)
        seq_cap = _ceil_to(9 * S + 64, 128)
        lens_dev = torch.from_numpy(lens_pad.astype(np.int32)).to(dev)
        with trace.span("zseek.plan"):
            mode, mode_bits, codes_packed, weights_packed, rle, sizes4 = \
                hp.plan_blocks(seqs["hist"], seqs["lit_count"],
                               seqs["n_seq"], seqs["const"], lens_dev,
                               mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
                               mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ,
                               hist_q=seqs["hist_q"])
            sflags, ctabs, norms, rle_syms, _gain = fpl.plan_seq_tables(
                seqs["ll"], seqs["ml"], seqs["offv"], seqs["n_seq"])
        mode_bits = mode_bits | torch.where(
            (mode_bits & E.MODE_SEQ) != 0, sflags, torch.zeros_like(sflags))
        lit_count = seqs["lit_count"]
        # rows K3 takes: full blocks, 4-stream Huffman, enough literals
        vec_mask = ((mode_bits & E.MODE_HUF) != 0) & \
            ((mode_bits & E.MODE_HUF1) == 0) & (lit_count >= VE.VEC_MIN_LC)
        if N != VE.N_BLOCK:
            vec_mask = torch.zeros_like(vec_mask)
        kmode = torch.where(vec_mask, mode_bits & ~E.MODE_HUF, mode_bits)
        meta = torch.cat([torch.stack([lens_dev, lit_count, seqs["n_seq"],
                                       kmode], 1), sizes4], 1)
        with trace.span("zseek.entropy"):
            lit_w, seq_w, osz, lanch, sanch = E.entropy_emit(
                x_dev, seqs["ll"], seqs["ml"], seqs["offv"], meta,
                codes_packed, S, lit_cap, seq_cap, ctabs=ctabs)
        if bool(vec_mask.any()):
            with trace.span("zseek.vector_literals"):
                vflat, vsz, vanch = VE.vector_literals(
                    x_dev, seqs["lit_mask"], codes_packed, lens_dev,
                    vec_mask, lit_cap)
            lit_w = torch.where(vec_mask[:, None], vflat, lit_w)
            osz = torch.cat([torch.where(vec_mask[:, None], vsz, osz[:, :4]),
                             osz[:, 4:]], 1)
            lanch = torch.where(vec_mask[:, None, None], vanch, lanch)
        lit_bytes = osz[:, :4].sum(1).to(torch.int32)
        seq_bytes = osz[:, 4]
        cap_words = self._cap_words_for(Bp * N // 4)
        with trace.span("zseek.compact"):
            flat, base_w, lw_w = compact_payload(lit_w, lit_bytes, seq_w,
                                                 seq_bytes, cap_words)
        # blocks whose offsets use repcodes 2/3 publish no sequence
        # anchors: the hint format reconstructs rep1 only
        offv = seqs["offv"]
        rep23 = ((offv == 2) | (offv == 3)).sum(1)
        parts = [lit_count, seqs["n_seq"], seqs["const"], mode, rle,
                 weights_packed, base_w, lw_w, osz, sflags, norms, rle_syms,
                 rep23, lanch, sanch]
        small = torch.cat([p.to(torch.int32).reshape(-1) for p in parts])
        return {"kind": "chain", "B": len(lens), "Bp": Bp, "lens": lens,
                "small": small, "device": dev,
                "flat": flat, "cap_words": cap_words,
                "streams": (lit_w, lit_bytes, seq_w, seq_bytes)}

    def _finish_chain(self, staged):
        """Fetch one batch's results and assemble its block payloads and
        decode hints."""
        B, Bp, lens = staged["B"], staged["Bp"], staged["lens"]
        with trace.span("zseek.fetch"):
            small = staged["small"].cpu().numpy()
            flat = staged["flat"].cpu().numpy()
        pos = 0

        def take(n, shape=None):
            nonlocal pos
            out = small[pos: pos + n]
            pos += n
            return out.reshape(shape) if shape else out

        lit_count = take(Bp)
        n_seq = take(Bp)
        const = take(Bp)
        mode = take(Bp)
        rle_byte = take(Bp)
        weights_packed = take(Bp * 32, (Bp, 32))
        base_w = take(Bp)
        lw_w = take(Bp)
        osz = take(Bp * 8, (Bp, 8))
        sflags = take(Bp)
        norms = take(Bp * fpl.NORM_WIDTH, (Bp, fpl.NORM_WIDTH))
        rle_syms = take(Bp * 3, (Bp, 3))
        rep23 = take(Bp)
        lmaxa, smaxa = E.anchor_slots(self.block, CAP)
        lit_anchors = take(Bp * 4 * lmaxa, (Bp, 4, lmaxa))
        sa = take(Bp * 5 * smaxa, (Bp, 5, smaxa))
        sa_bits = sa[:, 0]
        sa_states = np.stack([sa[:, 1], sa[:, 2], sa[:, 3]], axis=2)
        sa_rep1 = sa[:, 4]
        sizes4 = osz[:, :4]
        seq_sizes = osz[:, 4]
        need = int(base_w[Bp - 1] + lw_w[Bp - 1]
                   + (int(seq_sizes[Bp - 1]) + 3) // 4)
        if need > staged["cap_words"]:
            # the adaptive cap undershot: recompact at the exact bucket
            # and fetch again
            lit_w, lit_b, seq_w, seq_b = staged["streams"]
            flat_dev, base_d, lw_d = compact_payload(
                lit_w, lit_b, seq_w, seq_b, self._bucket_words(need))
            flat_bytes = flat_dev.cpu().numpy().view(np.uint8)
            base_w = base_d.cpu().numpy()
            lw_w = lw_d.cpu().numpy()
        else:
            flat_bytes = flat.view(np.uint8)
        self._needs.append(need)
        self._cap_hint = self._bucket_words(int(max(self._needs) * 1.4))

        with trace.span("zseek.assemble"):
            trees_all = native.huf_tree_batch(hp.unpack_weights(
                weights_packed[:B]))
            modes: list[str] = []
            trees: list[bytes | None] = []
            lit_rows: dict[int, np.ndarray] = {}
            for i in range(B):
                m = _MODE_NAMES[int(mode[i])]
                t = None
                if m in ("huf", "huf1"):
                    t = trees_all[i]
                    if t is None:
                        m = "skip"  # unserializable tree: store it raw
                elif m == "raw" and int(lit_count[i]) > 0:
                    lo = 4 * int(base_w[i])
                    lit_rows[i] = flat_bytes[lo: lo + int(lit_count[i])]
                modes.append(m)
                trees.append(t)
            ent = dict(sizes4=sizes4, seq_sizes=seq_sizes,
                       flat_bytes=flat_bytes, base_w=base_w, lw_w=lw_w,
                       lit_anchors=lit_anchors, sa_bits=sa_bits,
                       sa_states=sa_states, sa_rep1=sa_rep1,
                       lit_rows=lit_rows, modes=modes, rep23=rep23,
                       sflags=sflags, norms=norms, rle_syms=rle_syms)
            return self._assemble(B, lens, lit_count[:B], n_seq[:B], modes,
                                  trees, ent, const=const[:B], rle=rle_byte)

    def _finish_blocks(self, staged):
        """Finish one batch: the device chain's fetch and assembly, or the
        per-block path's table decisions, entropy arm and assembly.  Every
        tensor of the batch lies on its device, and kernels.launch enters
        that device for each launch."""
        if staged["kind"] == "chain":
            return self._finish_chain(staged)
        seqs, lens, x_dev = staged["seqs"], staged["lens"], staged["x"]
        B = len(lens)
        Bp = seqs["n_seq"].shape[0]
        with trace.span("zseek.fetch"):
            packed = staged["packed"].cpu().numpy()
        hist = packed[: Bp * 256].reshape(Bp, 256)[:B]
        lit_count = packed[Bp * 256: Bp * 257][:B]
        n_seq = packed[Bp * 257: Bp * 258][:B]
        const = packed[Bp * 258:][:B]
        nmax = int(n_seq.max()) if B else 0
        smax = min(max(16, 1 << max(0, nmax - 1).bit_length()),
                   seqs["ll"].shape[1])
        want_smem = self.entropy == "smem" or (
            self.entropy == "auto" and "literals" not in seqs)
        use_smem = want_smem and smax <= SMEM_SEQ_MAX
        if "literals" not in seqs and not use_smem:
            seqs = dict(seqs)
            seqs["literals"] = extract_literals(
                x_dev, torch.from_numpy(staged["lens_pad"]).to(x_dev.device),
                seqs["ll"], seqs["ml"], seqs["n_seq"])
        with trace.span("zseek.tables"):
            modes, trees, ests, code_vals, code_bits = self._decide_modes(
                hist, lit_count, n_seq, lens, Bp, exact=not use_smem,
                const=const)
        if use_smem:
            ent = self._entropy_smem(seqs, x_dev, lens, lit_count, n_seq,
                                     modes, ests, code_vals, code_bits, smax)
        else:
            ent = self._entropy_xla(seqs, lens, lit_count, n_seq, modes,
                                    trees, ests, code_vals, code_bits, smax)
        with trace.span("zseek.assemble"):
            return self._assemble(B, lens, lit_count, n_seq, modes, trees,
                                  ent, const=const, hist=hist)

    def _decide_modes(self, hist, lit_count, n_seq, lens, Bp, exact,
                      const):
        """Per-block literal-section modes and Huffman tables: "rleblock",
        "none", "rle", "raw", "huf", "huf1" or "skip" (stored raw, no
        streams).  Without `exact` (the K2 arm) the Huffman-or-raw choice
        uses the provable size bound, since K2's literals never reach the
        host, and blocks below 256 literals take the 1-stream layout."""
        B = len(lens)
        code_vals = np.zeros((Bp, 256), np.int32)
        code_bits = np.zeros((Bp, 256), np.int32)
        trees: list[bytes | None] = [None] * B
        modes: list[str] = ["raw"] * B
        ests: list[int] = [0] * B
        n_lengths, n_codes, n_trees, _mb = native.huf_build_batch(
            hist.astype(np.uint32))
        for i in range(B):
            lc = int(lit_count[i])
            blen = int(lens[i])
            if blen > 4 and const[i] >= 0:
                modes[i] = "rleblock"   # the whole block is one byte value
                continue
            if lc == 0:
                modes[i] = "none"
                continue
            raw_hdr = 1 if lc < 32 else (2 if lc < 4096 else 3)
            if np.count_nonzero(hist[i]) == 1:
                modes[i] = "rle"
                continue
            if lc < 64:
                ests[i] = lc + 8
                continue  # raw literals
            tree, lengths, codes = n_trees[i], n_lengths[i], n_codes[i]
            if tree is None:
                ests[i] = lc + 8
                continue
            one = lc < 256 and not exact   # 1-stream (K2 arm only)
            jump = 0 if one else 6
            pad = 2 if one else 8          # per-stream sentinel/rounding
            est_bits = int(np.sum(hist[i] * lengths))
            stream_bound = est_bits // 8 + pad
            est = est_bits // 8 + len(tree) + jump + pad
            if est >= lc:
                ests[i] = lc + 8
                continue
            if not exact:
                payload_bound = len(tree) + jump + stream_bound
                hdr = 3 if (lc <= 1023 and payload_bound <= 1023) else \
                    4 if (lc <= 16383 and payload_bound <= 16383) else 5
                if hdr + payload_bound >= raw_hdr + lc:
                    ests[i] = lc + 8
                    continue
            trees[i] = tree
            modes[i] = "huf1" if one else "huf"
            ests[i] = stream_bound
            code_vals[i] = codes
            code_bits[i] = lengths
        # raw-literal rows whose minimal payload already reaches the block
        # size are certain to be stored raw: no streams for them
        for i in range(B):
            if modes[i] != "raw":
                continue
            lc = int(lit_count[i])
            raw_hdr = 1 if lc < 32 else (2 if lc < 4096 else 3)
            if lc > 0 and raw_hdr + lc + 1 >= int(lens[i]):
                modes[i] = "skip"
                ests[i] = 0
        return modes, trees, ests, code_vals, code_bits

    def _fetch_payload(self, lit_w, lit_bytes, seq_w, seq_bytes, cap_words,
                       arrays):
        """compact_payload and one device-to-host transfer of the payload
        with `arrays` (device tensors): (flat bytes, base_w, lw_w, the
        arrays on the host in their shapes)."""
        Bp = lit_w.shape[0]
        with trace.span("zseek.compact"):
            flat, base_w, lw_w = compact_payload(lit_w, lit_bytes, seq_w,
                                                 seq_bytes, cap_words)
        parts = [base_w, lw_w] + [a.reshape(-1) for a in arrays]
        with trace.span("zseek.fetch"):
            got = torch.cat([p.to(torch.int32) for p in parts + [flat]]) \
                .cpu().numpy()
        pos = 2 * Bp
        outs = []
        for a in arrays:
            outs.append(got[pos: pos + a.numel()].reshape(a.shape))
            pos += a.numel()
        return got[pos:].view(np.uint8), got[:Bp], got[Bp: 2 * Bp], outs

    @staticmethod
    def _cap_words(ests, n_seq, Bp) -> int:
        """Payload words the compaction reserves: the literal estimates,
        9 bytes per sequence, and two 128-byte tiles of padding per row."""
        cap_bytes = sum(e + 16 for e in ests) + \
            int(np.sum(n_seq.astype(np.int64) * 9 + 12)) + 256 + 256 * Bp
        return max(1024, 1 << int(cap_bytes // 4).bit_length())

    @staticmethod
    def _check_need(B, base_w, lw_w, seq_sizes, cap_words):
        if B:
            need = int(base_w[B - 1] + lw_w[B - 1]
                       + (int(seq_sizes[B - 1]) + 3) // 4)
            if need > cap_words:
                raise RuntimeError(f"payload compaction overflow: {need} > "
                                   f"{cap_words} words")

    def _entropy_smem(self, seqs, x_dev, lens, lit_count, n_seq, modes,
                      ests, code_vals, code_bits, smax):
        """The K2 arm: host-built codes, per-stream byte sizes from the
        per-stream histograms, predefined sequence tables."""
        dev = x_dev.device
        B = len(lens)
        Bp = seqs["n_seq"].shape[0]
        N = self.block
        S = max(SMEM_SEQ_MIN, smax)
        mode_bits = np.zeros((Bp,), np.int32)
        for i in range(B):
            m = modes[i]
            if m == "huf":
                mode_bits[i] = E.MODE_HUF | E.MODE_SEQ
            elif m == "huf1":
                mode_bits[i] = E.MODE_HUF | E.MODE_HUF1 | E.MODE_SEQ
            elif m == "raw" and int(lit_count[i]) > 0:
                mode_bits[i] = E.MODE_RAWLIT | E.MODE_SEQ
            elif m in ("none", "rle", "raw"):
                mode_bits[i] = E.MODE_SEQ
        meta = np.zeros((Bp, 8), np.int32)
        meta[:B, 0] = lens
        meta[:B, 1] = lit_count
        meta[:B, 2] = n_seq
        meta[:B, 3] = mode_bits[:B]
        # exact per-stream byte sizes place K2's four literal streams
        hq = seqs["hist_q"][:B].cpu().numpy().astype(np.int64)
        bits_q = np.sum(hq * code_bits[:B, None, :], axis=2)
        for i in range(B):
            if modes[i] == "huf":
                meta[i, 4:8] = (bits_q[i] + 1 + 7) >> 3
            elif modes[i] == "huf1":
                meta[i, 4] = (int(bits_q[i].sum()) + 1 + 7) >> 3
        codes = torch.from_numpy((code_vals << 4) | code_bits).to(dev)
        cut = lambda a: a[:, :S].contiguous()
        with trace.span("zseek.entropy"):
            lit_w, seq_w, osz, lanch, sanch = E.entropy_emit(
                x_dev, cut(seqs["ll"]), cut(seqs["ml"]), cut(seqs["offv"]),
                torch.from_numpy(meta).to(dev), codes, S,
                _ceil_to(N + 64, 128), _ceil_to(9 * S + 64, 128))
        offv = seqs["offv"]
        rep23 = ((offv == 2) | (offv == 3)).sum(1)
        cap_words = self._cap_words(ests, n_seq, Bp)
        flat_bytes, base_w, lw_w, (osz, lanch, sa, rep23) = \
            self._fetch_payload(lit_w, osz[:, :4].sum(1), seq_w, osz[:, 4],
                                cap_words, [osz, lanch, sanch, rep23])
        self._check_need(B, base_w, lw_w, osz[:, 4], cap_words)
        lit_rows = {i: flat_bytes[4 * int(base_w[i]):
                                  4 * int(base_w[i]) + int(lit_count[i])]
                    for i in range(B) if mode_bits[i] & E.MODE_RAWLIT}
        return dict(sizes4=osz[:, :4], seq_sizes=osz[:, 4],
                    flat_bytes=flat_bytes, base_w=base_w, lw_w=lw_w,
                    lit_anchors=lanch, sa_bits=sa[:, 0],
                    sa_states=np.stack([sa[:, 1], sa[:, 2], sa[:, 3]], 2),
                    sa_rep1=sa[:, 4], lit_rows=lit_rows, modes=modes,
                    rep23=rep23)

    def _entropy_xla(self, seqs, lens, lit_count, n_seq, modes, trees,
                     ests, code_vals, code_bits, smax):
        """The XLA arm (ops/xla_entropy.py): 4-stream Huffman over the
        literal plane of the "huf" rows and FSE with the predefined tables,
        then the exact Huffman-to-raw fallback from the fetched sizes."""
        dev = seqs["ll"].device
        t = lambda a: torch.from_numpy(a).to(dev)
        B = len(lens)
        Bp = seqs["n_seq"].shape[0]
        N = self.block
        # rows already decided non-Huffman are masked out of the literal
        # stage, so they do not widen it to the block size
        huf = np.array([m == "huf" for m in modes], bool)
        lit_count_huf = np.zeros((Bp,), np.int32)
        lit_count_huf[:B] = np.where(huf, lit_count, 0)
        lmax = int(lit_count_huf.max())
        lcap = min(N, max(128, 1 << max(0, lmax - 1).bit_length()))
        with trace.span("zseek.huffman"):
            streams, sizes4, lanch = XE.huffman_encode_literals(
                seqs["literals"][:, :lcap], t(lit_count_huf), t(code_vals),
                t(code_bits), _ceil_to(lcap + 64, 128),
                anchor_interval=LIT_ANCHOR_INTERVAL, return_words=True)
        cut = lambda a: a[:, :smax]
        with trace.span("zseek.fse"):
            seq_w, seq_sizes, (sa_bits, sa_states, sa_rep1) = \
                XE.fse_encode_sequences(
                    cut(seqs["ll"]), cut(seqs["ml"]), cut(seqs["offv"]),
                    seqs["n_seq"], _ceil_to(min(N // 2, 11 * smax) + 64, 128),
                    smax=smax, anchor_interval=SEQ_ANCHOR_INTERVAL,
                    return_words=True)
        huf_mask = np.zeros((Bp,), np.int32)
        huf_mask[:B] = huf
        offv = seqs["offv"]
        rep23 = ((offv == 2) | (offv == 3)).sum(1)
        cap_words = self._cap_words(ests, n_seq, Bp)
        flat_bytes, base_w, lw_w, outs = self._fetch_payload(
            streams, sizes4.sum(1) * t(huf_mask), seq_w, seq_sizes,
            cap_words, [sizes4, seq_sizes, lanch, sa_bits, sa_states,
                        sa_rep1, rep23])
        sizes4, seq_sizes, lanch, sa_bits, sa_states, sa_rep1, rep23 = outs
        self._check_need(B, base_w, lw_w, seq_sizes, cap_words)
        # the exact Huffman-or-raw choice, now that the sizes are known
        for i in range(B):
            if modes[i] != "huf":
                continue
            lc = int(lit_count[i])
            payload_len = len(trees[i]) + 6 + int(sizes4[i].sum())
            hdr = 3 if (lc <= 1023 and payload_len <= 1023) else \
                4 if (lc <= 16383 and payload_len <= 16383) else 5
            raw_hdr = 1 if lc < 32 else (2 if lc < 4096 else 3)
            if hdr + payload_len >= raw_hdr + lc:
                modes[i] = "raw"
                trees[i] = None
        need_rows = [i for i in range(B)
                     if modes[i] == "raw" and lit_count[i] > 0]
        lit_rows = {}
        if need_rows:
            with trace.span("zseek.fetch"):
                picked = seqs["literals"][t(np.array(need_rows))].cpu() \
                    .numpy()
            lit_rows = {r: picked[k][: int(lit_count[r])]
                        for k, r in enumerate(need_rows)}
        return dict(sizes4=sizes4, seq_sizes=seq_sizes,
                    flat_bytes=flat_bytes, base_w=base_w, lw_w=lw_w,
                    lit_anchors=lanch, sa_bits=sa_bits, sa_states=sa_states,
                    sa_rep1=sa_rep1, lit_rows=lit_rows, modes=modes,
                    rep23=rep23)

    @staticmethod
    def _seq_table_desc(ent, i) -> bytes:
        """Compression-modes byte + table descriptions (RFC 8878
        §3.1.1.3.2.1): Predefined (0), RLE (1: one symbol byte) or
        FSE_Compressed (2: serialized normalized counts), in LL, OF, ML
        order.  The per-block path plans no sequence tables: all
        predefined."""
        if "sflags" not in ent:
            return bytes([0x00])
        fl = int(ent["sflags"][i])
        out = bytearray()
        modes2 = []
        descs = []
        off = 0
        for ki, (key, rbit, fbit) in enumerate((
                ("ll", E.MODE_LL_RLE, E.MODE_LL_FSE),
                ("of", E.MODE_OF_RLE, E.MODE_OF_FSE),
                ("ml", E.MODE_ML_RLE, E.MODE_ML_FSE))):
            nsym = fpl.NSYMS[key]
            if fl & rbit:
                modes2.append(1)
                descs.append(bytes([int(ent["rle_syms"][i, ki])]))
            elif fl & fbit:
                modes2.append(2)
                norm = np.asarray(ent["norms"][i, off: off + nsym])
                lg = (fl >> E.MODE_LOG_SHIFT[key]) & 15
                descs.append(fse.write_norm_counts(
                    norm, lg or fpl.LOGS[key]))
            else:
                modes2.append(0)
                descs.append(b"")
            off += nsym
        out.append((modes2[0] << 6) | (modes2[1] << 4) | (modes2[2] << 2))
        for d in descs:
            out += d
        return bytes(out)

    def _assemble(self, B, lens, lit_count, n_seq, modes, trees, ent,
                  const, rle=None, hist=None):
        """Build per-block payloads + decode hints from fetched streams."""
        sizes4 = ent["sizes4"]
        seq_sizes = ent["seq_sizes"]
        flat_bytes = ent["flat_bytes"]
        base_w = ent["base_w"]
        lw_w = ent["lw_w"]
        lit_anchors = ent["lit_anchors"]
        sa_bits, sa_states, sa_rep1 = (ent["sa_bits"], ent["sa_states"],
                                       ent["sa_rep1"])
        lit_rows = ent["lit_rows"]
        rep23 = ent["rep23"]
        out: list[bytes | tuple | None] = []
        out_h: list[object | None] = []
        for i in range(B):
            lc = int(lit_count[i])
            if modes[i] == "skip":
                out.append(None)
                out_h.append(None)
                continue
            if modes[i] == "rleblock":
                out.append(("rle", int(const[i])))
                out_h.append(None)
                continue
            lit_h = None
            if modes[i] == "none":
                lit_sec = _lit_section_raw(b"")
            elif modes[i] == "rle":
                b = int(rle[i]) if rle is not None \
                    else int(np.argmax(hist[i]))
                lit_sec = _lit_section_rle(b, lc)
            elif modes[i] == "huf1":
                lo = 4 * int(base_w[i])
                payload = trees[i] + \
                    flat_bytes[lo: lo + int(sizes4[i, 0])].tobytes()
                lit_sec = _lit_section_huff1(lc, len(payload), payload)
            elif modes[i] == "huf":
                jump = b"".join(int(sizes4[i, k]).to_bytes(2, "little")
                                for k in range(3))
                lo = 4 * int(base_w[i])
                payload = trees[i] + jump + \
                    flat_bytes[lo: lo + int(sizes4[i].sum())].tobytes()
                lit_sec = _lit_section_huff(lc, len(payload), payload)
                sA = LIT_ANCHOR_INTERVAL
                s123 = (lc + 3) >> 2
                cnts = [s123, s123, s123, lc - 3 * s123]
                per = []
                for s4 in range(4):
                    na = max(0, -(-cnts[s4] // sA) - 1)
                    per.append(lit_anchors[i, s4, :na].tolist())
                lit_h = hints.StreamAnchors(sA, per)
            else:
                lits = lit_rows[i].tobytes() if i in lit_rows else b""
                lit_sec = _lit_section_raw(lits)
            ns = int(n_seq[i])
            seq_sec = _nbseq_header(ns)
            seq_h = None
            if ns > 0:
                seq_sec += self._seq_table_desc(ent, i)
                lo = 4 * int(base_w[i] + lw_w[i])
                seq_sec += flat_bytes[lo: lo + int(seq_sizes[i])].tobytes()
                if not rep23[i]:
                    sA = SEQ_ANCHOR_INTERVAL
                    na = max(0, -(-ns // sA) - 1)
                    seq_h = hints.SeqAnchors(
                        sA, sa_bits[i, :na].tolist(),
                        sa_states[i, :na].tolist(),
                        sa_rep1[i, :na].tolist())
            payload = lit_sec + seq_sec
            out.append(payload if len(payload) < int(lens[i]) else None)
            out_h.append(hints.BlockHints(lit_h, seq_h)
                         if self.collect_hints and (lit_h or seq_h)
                         else None)
        return out, out_h

    # --- decompress ---

    def decompress_frame(self, data: bytes, d_size: int,
                         frame_hints=None) -> bytes:
        return self.decompress_frames(
            [data], [d_size],
            None if frame_hints is None else [frame_hints])[0]

    def decompress_frames(self, datas, d_sizes, frame_hints=None,
                          to_device: bool = False):
        """Decode frames on the codec's device through the `decoder`
        route ("auto": transcode for host delivery, fused for device
        delivery): host bytes per frame, or with to_device=True one
        uint8 tensor per frame on the device.  frame_hints (per frame,
        the Writer's decode anchors, or None) anchor the lane route's
        walks; the transcode route splits a frame that has them into
        chunks; the fused route walks whole streams and does not read
        them.  A corrupt frame raises FormatError."""
        if self.decoder == "lanes":
            return zstd_decode.decode_frames_lanes(
                datas, d_sizes, frame_hints, to_device=to_device,
                device=self.device)
        if self.decoder == "auto" and not to_device:
            return zstd_decode.decode_frames_transcode(
                datas, d_sizes, frame_hints, device=self.device)
        return zstd_decode.decode_frames(datas, d_sizes, to_device=to_device,
                                         device=self.device)


class _ZstdStream:
    """Streaming compression session (see ZstdCodec.begin_stream).

    At most `depth` batches stay in flight: one worker thread fetches and
    assembles finished batches (in FIFO order) while the caller's thread
    uploads and dispatches later ones."""

    def __init__(self, codec: ZstdCodec, depth: int):
        self._codec = codec
        self._depth = max(1, depth)
        self._groups = deque()
        self._inflight = 0
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="zseek-finish")

    def submit(self, frames):
        codec = self._codec
        frames = list(frames)
        spans = codec._frame_spans(frames)
        g = {"frames": frames, "spans": spans, "batches": deque(),
             "payloads": {}, "bhints": {}}
        for lo in range(0, len(spans), codec.max_batch_blocks):
            chunk = spans[lo: lo + codec.max_batch_blocks]
            with trace.span("zseek.dispatch"):
                st = codec._dispatch_parse(
                    [np.frombuffer(frames[fi], np.uint8, sz, s)
                     for fi, s, sz in chunk],
                    first_flags=[s == 0 for _, s, _ in chunk])
                fut = self._pool.submit(self._finish, st, trace.current())
            g["batches"].append((lo, fut))
            self._inflight += 1
        self._groups.append(g)
        return self._drain(self._depth)

    def _finish(self, staged, cause):
        """One batch on the finishing thread, under the dispatch that
        queued it."""
        with trace.span("zseek.finish", cause):
            return self._codec._finish_blocks(staged)

    def finish(self):
        out = self._drain(0)
        self._pool.shutdown(wait=True)
        return out

    def _drain(self, depth: int):
        codec = self._codec
        while self._inflight > depth:
            g = next(gr for gr in self._groups if gr["batches"])
            lo0, fut = g["batches"].popleft()
            with trace.span("zseek.stream_wait"):
                payloads, bhints = fut.result()
            for i, (p, bh) in enumerate(zip(payloads, bhints)):
                g["payloads"][lo0 + i] = p
                g["bhints"][lo0 + i] = bh
            self._inflight -= 1
        done = []
        while self._groups and not self._groups[0]["batches"]:
            g = self._groups.popleft()
            with trace.span("zseek.assemble"):
                done.append(codec._assemble_frames(
                    g["frames"], g["spans"], g["payloads"], g["bhints"]))
        return done
