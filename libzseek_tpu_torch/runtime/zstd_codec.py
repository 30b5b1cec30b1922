"""zstd seekable-frame codec on the GPU: the level <= 3 write path and
the read path.

Counterpart of libzseek_tpu/runtime/zstd_codec.py ZstdCodec with
parser="linked", entropy="smem" (the reference's device chain):

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

The host assembly helpers are copies of the reference's (they sit in a
module that imports JAX); the byte-identity tests hold them to it.  The
reference's ZN_* environment knobs are not ported (their defaults are
fixed), nor its `workers` round-robin and its adaptive vector-literal
hint: every row K3 accepts goes through K3, with identical bits either
way.

Decoding (decompress_frames, the Reader's codec call) is the fused
route of the reference's decode_frames: host frame parse and row
packing, then K4 on the device (ops/zstd_decode.py, ops/decode.py).
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
from libzseek_tpu_torch.ops import zstd_decode
from libzseek_tpu_torch.ops.parse_linked import CAP
from libzseek_tpu_torch.ops.zstd_encode import (apply_ldm_override,
                                                compact_payload,
                                                ldm_literal_stats,
                                                zstd_sequences_linked)
from libzseek_tpu_torch.utils.device import resolve_device

# profiler ranges around the codec's stages (free when no profiler runs;
# read by libzseek_tpu_torch/profile_write.py)
_span = torch.profiler.record_function

BLOCK = zf.BLOCK_MAX          # 128 KiB, the format's largest block
MIN_BLOCK = 4096
LDM_MIN_DIST = 1 << 17        # long-distance matches beyond the window
MAX_BATCH_BLOCKS = 64         # blocks per device batch
LIT_ANCHOR_INTERVAL = E.LIT_ANCHOR_INTERVAL
SEQ_ANCHOR_INTERVAL = E.SEQ_ANCHOR_INTERVAL


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


class ZstdCodec:
    """zstd seekable-frame codec: compression and decompression on the
    GPU (or, with device="cpu", through every kernel's plain version, for
    tests).  Compression also yields per-block decode anchors
    (format/hints.py) that the Writer publishes in a skippable sidecar
    frame."""

    name = "zstd"
    supports_hints = True
    supports_device_frames = True

    def __init__(self, level: int = 3, device: str = "cuda",
                 block: int = BLOCK):
        if level >= 4:
            raise ParameterError(
                f"level {level}: the port compresses levels <= 3 only")
        if block & (block - 1) or not MIN_BLOCK <= block <= BLOCK:
            raise ParameterError(
                f"block size {block}: must be a power of two in "
                f"[{MIN_BLOCK}, {BLOCK}]")
        self.level = level
        self.device = resolve_device(device)
        self.block = block
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
        """Upload one batch and dispatch the device chain.  first_flags[i]
        marks a frame's first block; frame starts and the batch start are
        fenced off from the preceding row (min_abs)."""
        with _span("zseek.layout"):
            X, lens, min_abs, ldm, lens_parse = self._layout(blocks,
                                                             first_flags)
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        X2d = t(X)
        seqs = zstd_sequences_linked(
            X2d, t(lens), t(min_abs), level=self.level,
            parse_lengths=None if lens_parse is None else t(lens_parse))
        if ldm is not None:
            seqs = apply_ldm_override(seqs, ldm[0], lens, ldm[1])
        return self._dispatch_chain(seqs, lens[:len(blocks)], X2d[1:], lens)

    def _layout(self, blocks, first_flags):
        """Host batch layout: (Bp+1, N) rows with Bp = max(8, pow2), block
        r in row r+1, lengths, min_abs fences, and the native
        long-distance pre-pass."""
        B = len(blocks)
        Bp = max(8, 1 << max(0, (B - 1).bit_length()))
        N = self.block
        X = np.zeros((Bp + 1, N), np.uint8)
        lens = np.zeros((Bp,), np.int32)
        min_abs = np.zeros((Bp,), np.int32)
        frame_base = np.full((Bp,), -1, np.int64)
        fb = 0
        for i, blk in enumerate(blocks):
            X[i + 1, : len(blk)] = blk
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
        # the parse's window become single long-match sequences; covered
        # rows skip the parse, except the last of each run, which keeps
        # the hash table warm for the next uncovered block
        ldm = None
        lens_parse = None
        d = native.ldm_scan(X[1: B + 1].reshape(-1), B, N, frame_base[:B],
                            lens[:B], LDM_MIN_DIST)
        if (d[:, 0] > 0).any():
            ldm = ldm_literal_stats(d, blocks, Bp)
            cov = d[:, 0] > 0
            skip = cov.copy()
            skip[:-1] = cov[:-1] & cov[1:]
            if skip.any():
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

    def _dispatch_chain(self, seqs, lens, x_dev, lens_pad):
        dev = self.device
        Bp = seqs["n_seq"].shape[0]
        N = self.block
        S = seqs["ll"].shape[1]
        lit_cap = _ceil_to(N + 64, 128)
        seq_cap = _ceil_to(9 * S + 64, 128)
        lens_dev = torch.from_numpy(lens_pad.astype(np.int32)).to(dev)
        with _span("zseek.plan"):
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
        with _span("zseek.entropy"):
            lit_w, seq_w, osz, lanch, sanch = E.entropy_emit(
                x_dev, seqs["ll"], seqs["ml"], seqs["offv"], meta,
                codes_packed, S, lit_cap, seq_cap, ctabs=ctabs)
        if bool(vec_mask.any()):
            with _span("zseek.vector_literals"):
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
        with _span("zseek.compact"):
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
        return {"B": len(lens), "Bp": Bp, "lens": lens, "small": small,
                "flat": flat, "cap_words": cap_words,
                "streams": (lit_w, lit_bytes, seq_w, seq_bytes)}

    def _finish_chain(self, staged):
        """Fetch one batch's results and assemble its block payloads and
        decode hints."""
        B, Bp, lens = staged["B"], staged["Bp"], staged["lens"]
        with _span("zseek.fetch"):
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

        with _span("zseek.assemble"):
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

    @staticmethod
    def _seq_table_desc(ent, i) -> bytes:
        """Compression-modes byte + table descriptions (RFC 8878
        §3.1.1.3.2.1): Predefined (0), RLE (1: one symbol byte) or
        FSE_Compressed (2: serialized normalized counts), in LL, OF, ML
        order."""
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
                  const, rle):
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
                lit_sec = _lit_section_rle(int(rle[i]), lc)
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
                         if (lit_h or seq_h) else None)
        return out, out_h

    # --- decompress ---

    def decompress_frame(self, data: bytes, d_size: int,
                         frame_hints=None) -> bytes:
        return self.decompress_frames([data], [d_size])[0]

    def decompress_frames(self, datas, d_sizes, frame_hints=None,
                          to_device: bool = False):
        """Decode frames with K4 on the codec's device: host bytes per
        frame, or with to_device=True one uint8 tensor per frame on the
        device.  frame_hints (the Writer's decode anchors) are accepted
        for the Reader's interface and not needed: K4 walks whole streams.
        A corrupt frame raises FormatError."""
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
        for lo in range(0, len(spans), MAX_BATCH_BLOCKS):
            chunk = spans[lo: lo + MAX_BATCH_BLOCKS]
            st = codec._dispatch_parse(
                [np.frombuffer(frames[fi], np.uint8, sz, s)
                 for fi, s, sz in chunk],
                first_flags=[s == 0 for _, s, _ in chunk])
            g["batches"].append(
                (lo, self._pool.submit(codec._finish_chain, st)))
            self._inflight += 1
        self._groups.append(g)
        return self._drain(self._depth)

    def finish(self):
        out = self._drain(0)
        self._pool.shutdown(wait=True)
        return out

    def _drain(self, depth: int):
        codec = self._codec
        while self._inflight > depth:
            g = next(gr for gr in self._groups if gr["batches"])
            lo0, fut = g["batches"].popleft()
            payloads, bhints = fut.result()
            for i, (p, bh) in enumerate(zip(payloads, bhints)):
                g["payloads"][lo0 + i] = p
                g["bhints"][lo0 + i] = bh
            self._inflight -= 1
        done = []
        while self._groups and not self._groups[0]["batches"]:
            g = self._groups.popleft()
            done.append(codec._assemble_frames(
                g["frames"], g["spans"], g["payloads"], g["bhints"]))
        return done
