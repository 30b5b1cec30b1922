"""zstd frame decode: host container parse, the fused route around K4, the
lane route around the lane decoders and K6, and the transcode route
around K4's transcode arm and the host executor.

Counterpart of libzseek_tpu/ops/zstd_decode.py:

  host   — frame and block headers, literal-section headers, Huffman
           weight and FSE table descriptions (_parse_frame_impl :336,
           _parse_lit_section :220, _parse_seq_section :290), deduplicated
           into table registries (_HufReg :69, _FseReg :141);
  fused  — (decode_frames) the rows packed as _try_decode_smem does
           (:788-871), build_dtabs (the jitted _build_dtabs, :117-138, as
           torch ops) and K4 (ops/decode.py, csrc/decode.cu);
  lanes  — (decode_frames_lanes, the reference's :1323-1771 with
           ZN_DECODE_SMEM=off) Huffman lanes, plain or anchored at the
           Writer's sidecar hints (format/hints.py), FSE sequence lanes,
           plain with tagged repcodes or anchored (ops/lanes.py,
           csrc/huf_lanes.cu, csrc/fse_lanes.cu), host assembly of the
           per-block records, then K6 (ops/exec_blocks.py,
           csrc/exec_blocks.cu) on batches inside its limits and the
           pointer-doubling executor execute_sequences (:709, torch ops)
           on the rest;
  transcode — (decode_frames_transcode, the reference's
           _try_decode_transcode :948-1205, its first route for host
           delivery on the TPU) literal-only blocks copied on the host,
           Huffman literals decoded on the host (native huf_decode_batch),
           K4's transcode arm (ops/decode.transcode_blocks) turning the
           sequence streams into packed tokens on the device, and the
           native executor (zir_execute) expanding them into each frame.

Every RFC 8878 block, literal and table mode is parsed (raw, RLE,
compressed and treeless literals; predefined, RLE, compressed and repeat
FSE tables), so frames written by stock libzstd decode too.  Unlike
_try_decode_smem, the
fused packer predicts no block sizes: K4 places each block where the
previous one ended, checks a block's size only where its header gives it
(raw and RLE blocks, meta[1]; -1 otherwise) and decode_frames checks each
frame's total against its content size.  There is no second route: a
block K4 rejects raises FormatError.  So the reference's ladder for
host delivery (transcode, then fused, then its XLA lane passes where
_try_decode_smem returns None: a block larger than BLOCK_MAX, a d_off
not a multiple of 4, a size off the prediction, :775-800) has two rungs
here, transcode then fused: the fused route accepts every block the
third rung would take, with the same bytes (the codec's
decoder="auto", runtime/zstd_codec.py).  Every route runs on `device`,
"cuda" unless the caller asks for "cpu".  The lane route takes the
reference's TPU branch on every device: Huffman symbols stay on the
device and are scattered into K6's literal plane, and K6 runs whenever
the batch meets the reference's rule (:1578-1586).
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch

from libzseek_tpu_torch import native
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import exec_blocks as X
from libzseek_tpu_torch.ops import fse
from libzseek_tpu_torch.ops import huffman
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.utils import trace

_HUF_PEEK = D.HUF_PEEK  # libzstd's HUF_TABLELOG_MAX: accept 12-bit tables


def _sentinel_bits(stream: bytes) -> int:
    """Total payload bits of a backward FSE/Huffman stream (sentinel 1-bit
    excluded)."""
    if not stream or stream[-1] == 0:
        raise FormatError("corrupt backward bitstream (empty or zero last byte)")
    return 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


class _HufReg:
    """Deduplicated Huffman tables: only the (256,) weight vectors; the
    2^12-entry peek tables are built on the device (build_dtabs)."""

    def __init__(self):
        self.ids: dict[bytes, int] = {}
        self.weights: list[np.ndarray] = []
        self.tls: list[int] = []

    def add(self, weights: np.ndarray) -> int:
        key = weights.tobytes()
        if key not in self.ids:
            w = np.zeros(256, np.int32)
            w[: len(weights)] = weights
            total = int(np.sum(np.where(w > 0, 1 << (w - 1), 0)))
            if total <= 0 or total & (total - 1):
                raise FormatError("huffman weight sum is not a power of two")
            tl = total.bit_length() - 1
            if tl > _HUF_PEEK:
                raise FormatError(
                    f"huffman code length {tl} exceeds {_HUF_PEEK}")
            self.ids[key] = len(self.weights)
            self.weights.append(w)
            self.tls.append(tl)
        return self.ids[key]

    def weights_arr(self):
        """(T, 256) int32 weights + (T,) int32 table logs for the device
        table build."""
        if not self.weights:
            return np.zeros((1, 256), np.int32), np.ones(1, np.int32)
        return np.stack(self.weights), np.array(self.tls, np.int32)


def build_dtabs(weights: torch.Tensor, tls: torch.Tensor) -> torch.Tensor:
    """Huffman peek tables from zstd weights, on the weights' device:
    (T, 256) int32 weights and (T,) table logs -> (T, 2^12) int32 entries
    (nb << 8 | sym).  Canonical (valPerRank) assignment makes the table
    contiguous runs when symbols are enumerated longest code first (symbol
    order within a length): a stable argsort, a cumsum and a searchsorted
    (right side), as the reference's jnp.argsort / searchsorted."""
    dev = weights.device
    sym_ids = torch.arange(256, dtype=torch.int32, device=dev)[None, :]
    l = torch.where(weights > 0, tls[:, None] + 1 - weights,
                    torch.zeros_like(weights))
    size = torch.where(l > 0, torch.ones_like(l) << (_HUF_PEEK - l).clamp(0),
                       torch.zeros_like(l))
    key = torch.where(l > 0, (_HUF_PEEK - l) * 256 + sym_ids,
                      torch.full_like(l, 1 << 24))
    order = torch.argsort(key, dim=1, stable=True)
    sz_s = torch.gather(size, 1, order)
    l_s = torch.gather(l, 1, order)
    bounds = torch.cumsum(sz_s, dim=1, dtype=torch.int32)
    q = torch.arange(1 << _HUF_PEEK, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(bounds, q.expand(bounds.shape[0], -1).contiguous(),
                             right=True).clamp(0, 255)
    sym = torch.gather(order, 1, idx).to(torch.int32)
    nb = torch.gather(l_s, 1, idx)
    return (nb << 8) | sym


class _FseReg:
    """Deduplicated FSE decode tables packed as sym | nb<<8 | base<<16,
    padded to 512 entries; packed() stacks them for the sequence lanes."""

    def __init__(self):
        self.ids: dict[tuple, int] = {}
        self.tables: list[np.ndarray] = []

    @staticmethod
    def _pack(dt: fse.DecodeTable) -> np.ndarray:
        packed = (dt.symbol | (dt.nb_bits << 8) | (dt.new_state << 16))
        out = np.zeros(512, np.int32)
        out[: packed.shape[0]] = packed
        return out

    def add_norm(self, kind: str, norm: np.ndarray, table_log: int) -> int:
        key = (kind, table_log, norm.tobytes())
        if key not in self.ids:
            self.ids[key] = len(self.tables)
            self.tables.append(self._pack(fse.build_decode_table(norm,
                                                                 table_log)))
        return self.ids[key]

    def add_rle(self, kind: str, symbol: int) -> int:
        key = (kind, "rle", symbol)
        if key not in self.ids:
            self.ids[key] = len(self.tables)
            self.tables.append(self._pack(fse.DecodeTable(
                0, np.array([symbol], np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32))))
        return self.ids[key]

    def packed(self) -> np.ndarray:
        if not self.tables:
            return np.zeros((1, 512), np.int32)
        return np.stack(self.tables)


_PREDEF = {
    "ll": (zf.LL_DEFAULT_NORM, zf.LL_DEFAULT_LOG),
    "of": (zf.OF_DEFAULT_NORM, zf.OF_DEFAULT_LOG),
    "ml": (zf.ML_DEFAULT_NORM, zf.ML_DEFAULT_LOG),
}
_MAX_SYM = {"ll": zf.MAX_LL_CODE, "of": zf.MAX_OF_CODE, "ml": zf.MAX_ML_CODE}


@dataclasses.dataclass
class _HufLane:
    stream: bytes
    n_out: int
    tid: int


@dataclasses.dataclass
class _BlockPlan:
    content: int                      # regenerated size, -1 = not in header
    lit_direct: bytes | None = None   # raw/RLE literal bytes (or whole raw block)
    huf_lanes: list | None = None     # list[_HufLane], decoded -> literal bytes
    n_seq: int = 0
    seq_stream: bytes = b""
    ll_tid: int = 0
    of_tid: int = 0
    ml_tid: int = 0
    ll_tl: int = 0
    of_tl: int = 0
    ml_tl: int = 0


@dataclasses.dataclass
class _FramePlan:
    content_size: int
    blocks: list          # list[_BlockPlan]


def _parse_lit_section(data: bytes, pos: int, frame_state: dict,
                       hufreg: _HufReg):
    """Parse a literals section.  Returns (kind, payload, regen, pos') where
    kind is 'bytes' (payload = literal bytes) or 'huf'
    (payload = list[_HufLane])."""
    b0 = data[pos]
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3
    if lit_type in (0, 1):  # Raw / RLE
        if size_format in (0, 2):
            regen = b0 >> 3
            pos += 1
        elif size_format == 1:
            regen = (b0 >> 4) | (data[pos + 1] << 4)
            pos += 2
        else:
            regen = (b0 >> 4) | (data[pos + 1] << 4) | (data[pos + 2] << 12)
            pos += 3
        if lit_type == 0:
            payload = data[pos: pos + regen]
            if len(payload) != regen:
                raise FormatError("truncated raw literals")
            return "bytes", payload, regen, pos + regen
        return "bytes", bytes([data[pos]]) * regen, regen, pos + 1
    # Compressed (2) / Treeless (3)
    if size_format == 0:
        v = int.from_bytes(data[pos: pos + 3], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FF, v >> 14, pos + 3, False
    elif size_format == 1:
        v = int.from_bytes(data[pos: pos + 3], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FF, v >> 14, pos + 3, True
    elif size_format == 2:
        v = int.from_bytes(data[pos: pos + 4], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FFF, v >> 18, pos + 4, True
    else:
        v = int.from_bytes(data[pos: pos + 5], "little")
        regen, comp, pos, streams4 = (v >> 4) & 0x3FFFF, v >> 22, pos + 5, True
    end = pos + comp
    if lit_type == 2:
        weights, used = huffman.read_weights(data, pos)
        tid = hufreg.add(weights)
        frame_state["huf_tid"] = tid
        pos += used
    else:
        tid = frame_state.get("huf_tid")
        if tid is None:
            raise FormatError("treeless literals with no previous table")
    lanes: list[_HufLane] = []
    if streams4:
        if end - pos < 6:
            raise FormatError("truncated 4-stream jump table")
        s1 = int.from_bytes(data[pos: pos + 2], "little")
        s2 = int.from_bytes(data[pos + 2: pos + 4], "little")
        s3 = int.from_bytes(data[pos + 4: pos + 6], "little")
        pos += 6
        s4 = end - pos - s1 - s2 - s3
        if s4 <= 0:
            raise FormatError("bad 4-stream sizes")
        per = (regen + 3) // 4
        counts = [per, per, per, regen - 3 * per]
        for sz, n_out in zip((s1, s2, s3, s4), counts):
            lanes.append(_HufLane(data[pos: pos + sz], n_out, tid))
            pos += sz
    else:
        lanes.append(_HufLane(data[pos: end], regen, tid))
    return "huf", lanes, regen, end


def _parse_seq_section(data: bytes, pos: int, end: int, frame_state: dict,
                       fsereg: _FseReg):
    """Parse a sequences section.  Returns _BlockPlan fields (a dict)."""
    b0 = data[pos]
    if b0 < 128:
        n_seq, pos = b0, pos + 1
    elif b0 < 255:
        n_seq, pos = ((b0 - 128) << 8) | data[pos + 1], pos + 2
    else:
        n_seq = int.from_bytes(data[pos + 1: pos + 3], "little") + 0x7F00
        pos += 3
    if n_seq == 0:
        return dict(n_seq=0)
    modes = data[pos]
    if modes & 3:
        raise FormatError("reserved sequence-section mode bits set")
    pos += 1
    out: dict = dict(n_seq=n_seq)
    for kind, mode in (("ll", (modes >> 6) & 3), ("of", (modes >> 4) & 3),
                       ("ml", (modes >> 2) & 3)):
        if mode == 0:
            norm, tl = _PREDEF[kind]
            tid = fsereg.add_norm(kind, norm, tl)
        elif mode == 1:
            tid = fsereg.add_rle(kind, data[pos])
            tl = 0
            pos += 1
        elif mode == 2:
            norm, tl, used = fse.read_norm_counts(data, pos, _MAX_SYM[kind])
            max_log = {"ll": 9, "of": 8, "ml": 9}[kind]
            if tl > max_log:
                raise FormatError(f"{kind} accuracy log {tl} exceeds {max_log}")
            tid = fsereg.add_norm(kind, norm, tl)
            pos += used
        else:
            prev = frame_state.get(f"fse_{kind}")
            if prev is None:
                raise FormatError("repeat FSE mode with no previous table")
            tid, tl = prev
        frame_state[f"fse_{kind}"] = (tid, tl)
        out[f"{kind}_tid"] = tid
        out[f"{kind}_tl"] = tl
    out["seq_stream"] = data[pos:end]
    return out


def _parse_frame_impl(data: bytes, hufreg: _HufReg, fsereg: _FseReg,
                      expected_size: int | None = None) -> _FramePlan:
    fh = zf.parse_frame_header(data, 0)
    pos = fh.header_size
    blocks: list[_BlockPlan] = []
    frame_state: dict = {}
    while True:
        btype, bsize, last = zf.parse_block_header(data, pos)
        pos += 3
        if btype == zf.BLOCK_RAW:
            payload = data[pos: pos + bsize]
            if len(payload) != bsize:
                raise FormatError("truncated raw block")
            blocks.append(_BlockPlan(content=bsize, lit_direct=payload))
            pos += bsize
        elif btype == zf.BLOCK_RLE:
            if pos >= len(data):
                raise FormatError("truncated RLE block")
            blocks.append(_BlockPlan(content=bsize,
                                     lit_direct=bytes([data[pos]]) * bsize))
            pos += 1
        else:
            end = pos + bsize
            kind, payload, regen, pos = _parse_lit_section(
                data, pos, frame_state, hufreg)
            seq = _parse_seq_section(data, pos, end, frame_state, fsereg)
            bp = _BlockPlan(content=-1, **seq)
            if kind == "bytes":
                bp.lit_direct = payload
            else:
                bp.huf_lanes = payload
            blocks.append(bp)
            pos = end
        if last:
            break
    cs = fh.content_size
    if cs is None:
        cs = expected_size
    if cs is None:
        raise FormatError("frame without content size needs expected_size")
    return _FramePlan(int(cs), blocks)


def _round_words(nbytes: int) -> int:
    """Row width in int32 words: the longest payload, rounded up to 256
    words (bounded variety of upload shapes, <= 1 KiB of padding)."""
    return max(256, -(-max(nbytes, 1) // 1024) * 256)


def _pack_sections(i: int, bp: _BlockPlan, huf: bool, meta, wtid, ftabs,
                   fse_packed) -> tuple[int, bytes, bytes]:
    """Row i's Huffman streams (when `huf`) and sequence section: fills
    meta's stream fields, wtid and ftabs; returns (mode bits, literal
    payload, sequence stream)."""
    mode, payload, seq = 0, b"", b""
    if huf:
        lanes = bp.huf_lanes
        mode |= D.DMODE_HUF1 if len(lanes) == 1 else D.DMODE_HUF4
        off = 0
        for s, lane in enumerate(lanes):
            meta[i, 4 + s] = _sentinel_bits(lane.stream)
            meta[i, 8 + s] = off
            off += len(lane.stream)
        payload = b"".join(lane.stream for lane in lanes)
        wtid[i] = lanes[0].tid
    if bp.n_seq > 0:
        mode |= D.DMODE_SEQ
        meta[i, 12] = _sentinel_bits(bp.seq_stream)
        meta[i, 13] = bp.n_seq
        meta[i, 14] = bp.ll_tl | (bp.of_tl << 8) | (bp.ml_tl << 16)
        ftabs[i, 0:512] = fse_packed[bp.ll_tid]
        ftabs[i, 512:1024] = fse_packed[bp.of_tid]
        ftabs[i, 1024:1536] = fse_packed[bp.ml_tid]
        seq = bp.seq_stream
    return mode, payload, seq


def _words(parts: list[bytes]) -> np.ndarray:
    """Byte strings as zero-padded rows of int32 words (_round_words of
    the longest)."""
    W = _round_words(max(map(len, parts), default=0))
    out = np.zeros((len(parts), 4 * W), np.uint8)
    for r, b in enumerate(parts):
        out[r, : len(b)] = np.frombuffer(b, np.uint8)
    return out.view("<i4")


def pack_rows(plans, hufreg: _HufReg, fsereg: _FseReg) -> dict:
    """K4's packed rows for the frames `plans`, frame-major (numpy):
    lp (B, LPW) / sq (B, SQW) int32 payload words, wtid (B,) Huffman
    table ids, ftabs (B, 1536), meta (B, 16), chain (F + 1,) int32 row
    offsets, frame_off (F + 1,) int64 output offsets, and payload_bytes,
    the compressed bytes the rows carry."""
    B = sum(len(p.blocks) for p in plans)
    meta = np.zeros((B, D.META_W), np.int32)
    wtid = np.zeros(B, np.int64)
    ftabs = np.zeros((B, 1536), np.int32)
    fse_packed = fsereg.packed()
    chain = np.zeros(len(plans) + 1, np.int32)
    frame_off = np.zeros(len(plans) + 1, np.int64)
    lp_list: list[bytes] = []
    sq_list: list[bytes] = []
    i = 0
    for f, p in enumerate(plans):
        chain[f] = i
        frame_off[f + 1] = frame_off[f] + p.content_size
        for bi, bp in enumerate(p.blocks):
            mode, payload, seq = _pack_sections(i, bp, bool(bp.huf_lanes),
                                                meta, wtid, ftabs, fse_packed)
            if bi == 0:
                mode |= D.DMODE_FRAME_START
            if not bp.huf_lanes and bp.lit_direct is not None:
                mode |= D.DMODE_DIRECT
                payload = bp.lit_direct
            regen = _lit_len(bp)
            if regen > zf.BLOCK_MAX:
                raise FormatError(f"block regenerates {regen} literal bytes")
            lp_list.append(payload)
            sq_list.append(seq)
            meta[i, 0] = mode
            meta[i, 1] = bp.content
            meta[i, 3] = regen
            i += 1
    chain[-1] = B
    return dict(lp=_words(lp_list), sq=_words(sq_list), wtid=wtid,
                ftabs=ftabs, meta=meta, chain=chain, frame_off=frame_off,
                payload_bytes=sum(map(len, lp_list)) + sum(map(len, sq_list)))


def k4_inputs(datas, d_sizes, device) -> tuple[tuple, int, dict]:
    """Parse and pack frames, upload the rows to `device` and build their
    Huffman tables there: (K4's arguments, out_size, the packed rows)."""
    with trace.span("zseek.parse"):
        hufreg, fsereg = _HufReg(), _FseReg()
        plans = [_parse_frame_impl(d, hufreg, fsereg, sz)
                 for d, sz in zip(datas, d_sizes)]
        rows = pack_rows(plans, hufreg, fsereg)
    with trace.span("zseek.upload"):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        W, TLS = hufreg.weights_arr()
        dtabs = build_dtabs(t(W), t(TLS)).index_select(0, t(rows["wtid"]))
        args = (t(rows["lp"]), t(rows["sq"]), dtabs.contiguous(),
                t(rows["ftabs"]), t(rows["meta"]), t(rows["chain"]),
                t(rows["frame_off"]))
    return args, int(rows["frame_off"][-1]), rows


def decode_frames(datas, d_sizes=None, to_device: bool = False,
                  device="cuda"):
    """Decode a batch of zstd frames with K4 on `device`.

    Returns host `bytes` per frame, or with to_device=True one uint8
    tensor per frame on `device` (views of one flat output).  A block K4
    rejects, or a frame whose blocks do not add up to its content size,
    raises FormatError."""
    if not datas:
        return []
    if d_sizes is None:
        d_sizes = [None] * len(datas)
    args, out_size, rows = k4_inputs(datas, d_sizes, torch.device(device))
    with trace.span("zseek.k4"):
        out, stat = D.decode_blocks(*args, out_size,
                                    n_seqs=D.seq_total(rows["meta"]))
    with trace.span("zseek.fetch"):
        stat = stat.cpu().numpy()
    chain, frame_off = rows["chain"], rows["frame_off"]
    for f in range(len(datas)):
        s = stat[chain[f]: chain[f + 1]]
        bad = np.nonzero(s[:, 1] != 1)[0]
        if len(bad):
            raise FormatError(f"frame {f}: block {int(bad[0])} is corrupt")
        if int(s[:, 0].sum()) != frame_off[f + 1] - frame_off[f]:
            raise FormatError(f"frame {f}: blocks decode to {int(s[:, 0].sum())}"
                              f" bytes, the header says "
                              f"{frame_off[f + 1] - frame_off[f]}")
    if to_device:
        return [out[int(frame_off[f]): int(frame_off[f + 1])]
                for f in range(len(datas))]
    with trace.span("zseek.fetch"):
        host = out.cpu().numpy()
        return [host[frame_off[f]: frame_off[f + 1]].tobytes()
                for f in range(len(datas))]


# ---------------------------------------------------------------------------
# the lane route
# ---------------------------------------------------------------------------

K6_SEQ_SLOTS = 8191         # K6's sequence slots a block (pseudo-sequence in)
K6_MAX_OFFSET = 1 << 17     # the reference K6's ring bound on an offset

# the lane route's frames and executor batches, and the transcode route's
# batches, by the way they went (read by chip_smoke.py): a transcode batch
# runs K4's transcode arm, or goes to the fused route by rule before it
# (its predicted block sizes do not add up) or after it (a row's stat
# fails: an offset the token cannot hold, a size off the prediction, a
# corrupt stream); the Reader decodes from two threads, hence the lock
routes = {"anchored_frames": 0, "plain_frames": 0, "k6_batches": 0,
          "pointer_doubling_batches": 0, "transcode_batches": 0,
          "transcode_rule_batches": 0, "transcode_fallback_batches": 0}
_routes_lock = threading.Lock()


def _count_route(key: str, n: int = 1) -> None:
    with _routes_lock:
        routes[key] += n


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _resolve_tags(vals: np.ndarray, reps: np.ndarray) -> np.ndarray:
    """Replace tagged rep values -(k*REP_TAG + d) with reps[k-1] - d."""
    tagged = vals < 0
    if not tagged.any():
        return vals
    enc = -vals[tagged]
    k = enc // L.REP_TAG
    d = enc % L.REP_TAG
    out = vals.copy()
    out[tagged] = reps[k - 1] - d
    return out


def _frame_hints_usable(plan: _FramePlan, fh) -> bool:
    """Hints apply only when every compressed block of the frame has them
    (our encoder's output) — mixing anchored and tagged-rep blocks would
    break the cross-block repcode chain."""
    if fh is None:
        return False
    if len(fh) != len(plan.blocks):
        return False
    for bp, bh in zip(plan.blocks, fh):
        if not (bp.huf_lanes or bp.n_seq > 0):
            continue
        if bh is None:
            return False
        if bp.huf_lanes and (bh.lit is None or bh.lit.interval <= 0 or
                             len(bh.lit.bitpos) != len(bp.huf_lanes)):
            return False
        if bp.n_seq > 0 and (bh.seq is None or bh.seq.interval <= 0):
            return False
    return True


def _init_seq_states(stream: bytes, tls=(6, 5, 6)):
    """Host-side read of the three initial tANS states.  tls = the block's
    per-stream accuracy logs (LL, OF, ML): an RLE-mode stream has log 0 —
    no initial-state bits and a constant state 0."""
    total = _sentinel_bits(stream)
    val = int.from_bytes(stream, "little")
    pos = total
    states = []
    for log in tls:
        if log:
            states.append((val >> (pos - log)) & ((1 << log) - 1))
            pos -= log
        else:
            states.append(0)
    return pos, tuple(states)


def execute_sequences(pool, lit_src, lit_len, lit_dst, m_off, m_len, m_dst,
                      out_size: int):
    """Frame-wide LZ sequence execution (literal scatter + pointer-doubled
    back-reference chains), torch ops on the tensors' device.  pool: (B, P)
    uint8 literal bytes; the six sequence arrays are (B, S) int32.  Returns
    (out (B, out_size) uint8, ok (B,) bool), ok false where a match reaches
    before the frame's start."""
    B, P = pool.shape
    S = lit_src.shape[1]
    F = out_size
    dev = pool.device
    i32 = torch.int32
    seq_valid = lit_len > 0
    is_lit_src = C.fill_regions(P, lit_src, lit_src + lit_len, seq_valid)
    src_region = C.region_index(P, lit_src, seq_valid)
    lr_rank = torch.cumsum(seq_valid.to(i32), 1, dtype=i32) - 1
    zeros = torch.zeros((B, S), dtype=i32, device=dev)
    lit_src_tab = C.scatter1_set(zeros, lr_rank, lit_src, seq_valid)
    lit_dst_tab = C.scatter1_set(zeros, lr_rank, lit_dst, seq_valid)
    jpos = torch.arange(P, dtype=i32, device=dev).expand(B, P)
    ldst = C.take1(lit_dst_tab, src_region) + \
        (jpos - C.take1(lit_src_tab, src_region))
    val_layer = C.scatter1_set(torch.zeros((B, F), dtype=i32, device=dev),
                               ldst, pool.to(i32), is_lit_src)
    m_valid = m_len > 0
    in_match = C.fill_regions(F, m_dst, m_dst + m_len, m_valid)
    m_region = C.region_index(F, m_dst, m_valid)
    mr_rank = torch.cumsum(m_valid.to(i32), 1, dtype=i32) - 1
    m_off_tab = C.scatter1_set(torch.ones((B, S), dtype=i32, device=dev),
                               mr_rank, m_off, m_valid)
    ipos = torch.arange(F, dtype=i32, device=dev).expand(B, F)
    ref = ipos - C.take1(m_off_tab, m_region)
    bad = (in_match & (ref < 0)).any(1)
    src0 = torch.where(in_match, ref.clamp(0, F - 1), ipos)
    rounds = max(1, int(math.ceil(math.log2(max(2, F)))))
    src_final = C.resolve_copy_chains(src0, rounds)
    out = C.take1(val_layer, src_final).to(torch.uint8)
    return out, ~bad


def _lit_len(bp: _BlockPlan) -> int:
    if bp.huf_lanes:
        return sum(l.n_out for l in bp.huf_lanes)
    if bp.lit_direct is not None:
        return len(bp.lit_direct)
    return 0


def _scatter_chunks(plane, syms, dst, n):
    """Scatter lane symbols into the flat literal plane (1, BL * PW): lane
    row r covers plane[dst[r] : dst[r] + n[r]) (the reference's
    _scatter_chunks, :1249)."""
    col = torch.arange(syms.shape[1], device=syms.device)
    idx = dst[:, None] + col
    mask = col < n[:, None]
    return C.scatter1_set(plane, idx.reshape(1, -1), syms.reshape(1, -1),
                          mask.reshape(1, -1))


def huf_lane_inputs(lanes, anchors=None) -> tuple[dict, np.ndarray]:
    """The Huffman lane decoder's numpy inputs for `lanes` (_HufLane list).

    anchors None (pass A, :1333-1352): one lane per stream from its
    sentinel, exact consumption.  Else anchors[j] = (StreamAnchors, the
    stream's index in its block) for lanes[j] (pass A', :1366-1405): one
    lane per interval chunk from the anchor bit positions.  Returns
    (ops/lanes.huf_lanes's keyword arguments but dtabs, each lane's first
    symbol within its stream)."""
    bank = L.stream_bank([l.stream for l in lanes])
    starts = [_sentinel_bits(l.stream) for l in lanes]
    if anchors is None:
        n = np.array([l.n_out for l in lanes], np.int32)
        return dict(bank=bank, sid=np.arange(len(lanes), dtype=np.int32),
                    bits=np.array(starts, np.int32), n=n,
                    tid=np.array([l.tid for l in lanes], np.int32),
                    cap=max(1, _ceil_pow2(int(n.max()))), exact=True), \
            np.zeros(len(lanes), np.int64)
    chunks = []       # (stream, start bit, count, table, first symbol)
    for sid, (lane, (lh, s)) in enumerate(zip(lanes, anchors)):
        iv = lh.interval
        n_chunks = max(1, -(-lane.n_out // iv))
        if len(lh.bitpos[s]) < n_chunks - 1:
            raise FormatError("decode hints: too few literal anchors")
        for k in range(n_chunks):
            chunks.append((sid, starts[sid] if k == 0 else lh.bitpos[s][k - 1],
                           min(iv, lane.n_out - k * iv), lane.tid, k * iv))
    c = np.array(chunks, np.int64)
    i32 = c[:, :4].astype(np.int32)
    return dict(bank=bank, sid=i32[:, 0], bits=i32[:, 1], n=i32[:, 2],
                tid=i32[:, 3], cap=max(lh.interval for lh, _ in anchors),
                exact=False), c[:, 4]


def seq_lane_inputs(bps, anchors=None) -> tuple[dict, list]:
    """The sequence lane decoder's numpy inputs for blocks `bps` (_BlockPlan
    list with n_seq > 0).

    anchors None (pass B, :1433-1455): one lane per block, tagged
    repcodes.  Else anchors[j] = the SeqAnchors of bps[j] (pass B',
    :1466-1516): one lane per interval chunk from the checkpoints (the
    first from the stream's top, rep1 = 1).  Returns (ops/lanes.seq_lanes's
    keyword arguments but tabs, each block's (first lane, lane count))."""
    bank = L.stream_bank([bp.seq_stream for bp in bps])
    tids = [(bp.ll_tid, bp.of_tid, bp.ml_tid) for bp in bps]
    tls = [(bp.ll_tl, bp.of_tl, bp.ml_tl) for bp in bps]
    if anchors is None:
        nb = len(bps)
        n = np.array([bp.n_seq for bp in bps], np.int32)
        return dict(bank=bank, sid=np.arange(nb, dtype=np.int32),
                    bits=np.array([_sentinel_bits(bp.seq_stream)
                                   for bp in bps], np.int32),
                    n=n, states=np.zeros((nb, 3), np.int32),
                    rep1=np.ones(nb, np.int32),
                    tids=np.array(tids, np.int32),
                    tls=np.array(tls, np.int32),
                    cap=max(1, _ceil_pow2(int(n.max()))), tagged=True), \
            [(j, 1) for j in range(nb)]
    chunks = []   # (block, bit, count, s_ll, s_of, s_ml, rep1, 3 tables)
    spans = []
    for bi, (bp, sh) in enumerate(zip(bps, anchors)):
        iv = sh.interval
        pos0, st0 = _init_seq_states(bp.seq_stream, tls[bi])
        n_chunks = max(1, -(-bp.n_seq // iv))
        if min(len(sh.bitpos), len(sh.states),
               len(sh.rep1)) < n_chunks - 1:
            raise FormatError("decode hints: too few sequence anchors")
        spans.append((len(chunks), n_chunks))
        for k in range(n_chunks):
            if k == 0:
                bits, st, r1 = pos0, st0, 1
            else:
                bits = sh.bitpos[k - 1]
                # an RLE stream's state is identically 0 (its hint slot
                # holds the encoder's internal masked-walk state)
                st = tuple(v if tl else 0 for v, tl in
                           zip(sh.states[k - 1], tls[bi]))
                r1 = sh.rep1[k - 1]
            chunks.append((bi, bits, min(iv, bp.n_seq - k * iv), *st, r1,
                           *tids[bi]))
    c = np.array(chunks, np.int64).astype(np.int32)
    return dict(bank=bank, sid=c[:, 0].copy(), bits=c[:, 1].copy(),
                n=c[:, 2].copy(), states=c[:, 3:6].copy(),
                rep1=c[:, 6].copy(), tids=c[:, 7:10].copy(),
                tls=np.zeros((len(c), 3), np.int32),
                cap=max(sh.interval for sh in anchors), tagged=False), spans


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _upload(inp: dict, dev) -> dict:
    """A lane-input dict with its numpy arrays moved to `dev`."""
    return {k: _tensor(v, dev) if isinstance(v, np.ndarray) else v
            for k, v in inp.items()}


def decode_frames_lanes(datas, d_sizes=None, hints=None,
                        to_device: bool = False, device="cuda"):
    """Decode a batch of zstd frames through the lane route on `device`.

    hints: per-frame decode-anchor lists (format/hints.py, the Writer's
    sidecar) or None; a frame whose hints cover every compressed block
    (_frame_hints_usable) decodes in anchored chunk lanes, the others in
    one lane per Huffman stream and per sequence section.  Returns host
    `bytes` per frame, or with to_device=True one uint8 tensor per frame
    on `device`.  A corrupt frame raises FormatError."""
    if not datas:
        return []
    if d_sizes is None:
        d_sizes = [None] * len(datas)
    if hints is None:
        hints = [None] * len(datas)
    dev = torch.device(device)

    def up(a):
        return _tensor(a, dev)

    with trace.span("zseek.parse"):
        hufreg, fsereg = _HufReg(), _FseReg()
        plans = [_parse_frame_impl(d, hufreg, fsereg, sz)
                 for d, sz in zip(datas, d_sizes)]
    use_hints = [_frame_hints_usable(p, fh) for p, fh in zip(plans, hints)]
    _count_route("anchored_frames", sum(use_hints))
    _count_route("plain_frames", len(plans) - sum(use_hints))
    blocks = [bp for p in plans for bp in p.blocks]
    hint_of: dict[int, object] = {}      # block index -> its BlockHints
    i = 0
    for p, fh, uh in zip(plans, hints, use_hints):
        for bi in range(len(p.blocks)):
            if uh:
                hint_of[i] = fh[bi]
            i += 1
    BL = len(blocks)
    lit_lens = [_lit_len(bp) for bp in blocks]
    PW = max([zf.BLOCK_MAX] + lit_lens)   # literal plane row width

    # --- the literal plane: raw / RLE literal bytes from the host, the
    # Huffman lanes' symbols scattered in on the device ---
    with trace.span("zseek.upload"):
        template = np.zeros((BL, PW), np.uint8)
        for i, bp in enumerate(blocks):
            if not bp.huf_lanes and bp.lit_direct:
                template[i, : len(bp.lit_direct)] = np.frombuffer(
                    bp.lit_direct, np.uint8)
        plane = up(template).reshape(1, -1)
        dtabs = None
        if any(bp.huf_lanes for bp in blocks):
            W, TLS = hufreg.weights_arr()
            dtabs = build_dtabs(up(W), up(TLS))
        tabs = up(fsereg.packed())
    checks = []     # (ok tensor, message), checked in the reference's order

    # --- pass A: one lane per Huffman stream; pass A': one lane per
    # anchored chunk ---
    with trace.span("zseek.huf_lanes"):
        plain, anch = [], []      # (plane offset, lane, anchors)
        for i, bp in enumerate(blocks):
            po = i * PW
            for s, lane in enumerate(bp.huf_lanes or ()):
                if i in hint_of:
                    anch.append((po, lane, (hint_of[i].lit, s)))
                else:
                    plain.append((po, lane, None))
                po += lane.n_out
        for group, anchored, msg in (
                (plain, False, "huffman literal stream underflow"),
                (anch, True, "anchored huffman stream underflow")):
            if not group:
                continue
            inp, first = huf_lane_inputs([g[1] for g in group],
                                         [g[2] for g in group]
                                         if anchored else None)
            syms, ok = L.huf_lanes(dtabs=dtabs, **_upload(inp, dev))
            dst = np.array([g[0] for g in group], np.int64)[inp["sid"]] + \
                first
            plane = _scatter_chunks(plane, syms, up(dst), up(inp["n"]))
            checks.append((ok, msg))

    # --- pass B: one lane per sequence section, tagged repcodes; pass B':
    # one lane per anchored chunk ---
    seq_res: dict[int, tuple] = {}   # block -> (ll, ml, off, rep_final)
    with trace.span("zseek.seq_lanes"):
        passes = []
        for anchored, msg in ((False, "sequence bitstream underflow"),
                              (True, "anchored sequence stream underflow")):
            idx = [i for i, bp in enumerate(blocks)
                   if bp.n_seq > 0 and (i in hint_of) == anchored]
            if not idx:
                continue
            inp, spans = seq_lane_inputs(
                [blocks[i] for i in idx],
                [hint_of[i].seq for i in idx] if anchored else None)
            res = L.seq_lanes(tabs=tabs, **_upload(inp, dev))
            checks.append((res[4], msg))
            passes.append((idx, inp["n"], spans, anchored, res))

    with trace.span("zseek.fetch"):
        for ok, msg in checks:
            if not bool(ok.all()):
                raise FormatError(msg)
        for idx, cnt, spans, anchored, res in passes:
            lls, mls, offs, rep_fin = (t.cpu().numpy() for t in res[:4])
            for i, (first, k) in zip(idx, spans):
                rows = range(first, first + k)
                seq_res[i] = tuple(
                    np.concatenate([a[r, : cnt[r]] for r in rows])
                    for a in (lls, mls, offs)) + (
                    # anchored blocks leave reps (1, 4, 8) behind (:1528)
                    np.array([1, 4, 8], np.int32) if anchored
                    else rep_fin[first],)

    # --- host: per-block records (lengths and sequences; literal bytes
    # stay on the device) ---
    recs = []          # (ll, ml, off, content, d_off) per block
    i = 0
    for p in plans:
        d_off = 0
        reps = np.array([1, 4, 8], np.int64)
        for bp in p.blocks:
            ln = lit_lens[i]
            if bp.n_seq > 0:
                ll, ml, off, rep_fin = seq_res[i]
                off = _resolve_tags(off.astype(np.int64), reps)
                reps = _resolve_tags(rep_fin.astype(np.int64), reps)
                if (off <= 0).any():
                    raise FormatError("non-positive match offset")
                covered = int(ll.sum() + ml.sum())
                trailing = ln - int(ll.sum())
                if trailing < 0:
                    raise FormatError("literal pool underrun")
                content = covered + trailing
                b_ll, b_ml, b_off = ll, ml, off.astype(np.int32)
            else:
                content = ln
                b_ll = b_ml = b_off = np.zeros(0, np.int32)
            recs.append((b_ll, b_ml, b_off, content, d_off))
            d_off += content
            i += 1
        if d_off != p.content_size:
            raise FormatError(f"frame regenerated {d_off} != declared "
                              f"{p.content_size}")

    # --- execution: K6 when the batch meets the reference's rule
    # (:1578-1586, its TPU branch), else the pointer-doubling executor ---
    eligible = all(len(ll) + 1 <= K6_SEQ_SLOTS and content <= zf.BLOCK_MAX
                   and d_off % 4 == 0 and
                   not (len(off) and int(off.max()) >= K6_MAX_OFFSET)
                   for ll, _, off, content, d_off in recs)
    if eligible:
        _count_route("k6_batches")
        out, ok, spans = _execute_k6(plans, recs, plane.reshape(BL, PW), up)
        msg = ("corrupt sequences: a match reaches before its frame or a "
               "block overruns its size")
    else:
        _count_route("pointer_doubling_batches")
        out, ok, spans = _execute_pointer_doubling(plans, recs, lit_lens,
                                                   plane, PW, up)
        msg = "match offset before frame start"
    with trace.span("zseek.fetch"):
        if not bool(ok.all()):
            raise FormatError(msg)
        if to_device:
            return [out[a: b] for a, b in spans]
        host = out.cpu().numpy()
        return [host[a: b].tobytes() for a, b in spans]


def _execute_k6(plans, recs, lit, up):
    """K6 on the batch's per-block records (ll, ml, off, content, d_off)
    and literal plane `lit` (BL, PW): (flat output, ok per block, each
    frame's (start, end) in it)."""
    BL = len(recs)
    S2 = max(64, _ceil_pow2(1 + max(len(r[0]) for r in recs)))
    lla = np.zeros((BL, S2), np.int32)
    mla = np.zeros((BL, S2), np.int32)
    offa = np.ones((BL, S2), np.int32)
    meta = np.zeros((BL, 3), np.int32)
    for i, (ll, ml, off, content, d_off) in enumerate(recs):
        ns = len(ll)
        lla[i, :ns], mla[i, :ns], offa[i, :ns] = ll, ml, off
        trail = content - (int(ll.sum() + ml.sum()) if ns else 0)
        if trail > 0:                 # the trailing-literals pseudo-sequence
            lla[i, ns] = trail
            ns += 1
        meta[i] = (ns, content, d_off)
    chain = np.concatenate(
        [[0], np.cumsum([len(p.blocks) for p in plans])]).astype(np.int32)
    frame_off = np.concatenate(
        [[0], np.cumsum([p.content_size for p in plans])]).astype(np.int64)
    with trace.span("zseek.k6"):
        out, ok = X.execute_blocks(lit, up(lla), up(mla), up(offa), up(meta),
                                   up(chain), up(frame_off),
                                   int(frame_off[-1]),
                                   max_matches=X.match_bound(mla, chain))
    return out, ok, [(int(a), int(b)) for a, b in
                     zip(frame_off, frame_off[1:])]


def _execute_pointer_doubling(plans, recs, lit_lens, plane, PW, up):
    """execute_sequences on per-frame literal pools gathered from the
    plane (1, BL * PW) and the reference's sequence arrays (:1699-1765):
    (the (B, F) output flattened, ok per frame, each frame's (start, end)
    in it)."""
    frames_exec = []
    i = 0
    for p in plans:
        pidx, seqs = [], [[] for _ in range(6)]
        pool_pos = out_pos = 0
        for _ in p.blocks:
            ll, ml, off, content, _d = recs[i]
            pidx.append(i * PW + np.arange(lit_lens[i], dtype=np.int64))
            ns = len(ll)
            covered = int(ll.sum() + ml.sum()) if ns else 0
            if ns:
                ll64 = ll.astype(np.int64)
                ldst = out_pos + np.cumsum(ll64 + ml) - (ll64 + ml)
                for k, v in enumerate((pool_pos + np.cumsum(ll64) - ll64, ll,
                                       ldst, off, ml, ldst + ll)):
                    seqs[k].append(v)
            trail = content - covered
            consumed = int(ll.sum()) if ns else 0
            if trail > 0:
                for k, v in enumerate((pool_pos + consumed, trail,
                                       out_pos + covered, 1, 0,
                                       out_pos + content)):
                    seqs[k].append(np.array([v]))
            pool_pos += consumed + max(0, trail)
            out_pos += content
            i += 1
        frames_exec.append((np.concatenate(pidx),
                            [np.concatenate(v).astype(np.int32) if v
                             else np.zeros(0, np.int32) for v in seqs],
                            out_pos))
    B = len(frames_exec)
    F = max(1, _ceil_pow2(max(fe[2] for fe in frames_exec)))
    P = max(1, _ceil_pow2(max(len(fe[0]) for fe in frames_exec)))
    S = max(1, _ceil_pow2(max(len(fe[1][0]) for fe in frames_exec)))
    pool_idx = np.full((B, P), plane.shape[1], np.int64)  # an appended zero
    arrs = [np.zeros((B, S), np.int32) for _ in range(6)]
    for f, (pi, seqs, _n) in enumerate(frames_exec):
        pool_idx[f, : len(pi)] = pi
        for k in range(6):
            arrs[k][f, : len(seqs[k])] = seqs[k]
    with trace.span("zseek.execute"):
        flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
        out, ok = execute_sequences(flat[up(pool_idx)],
                                    *[up(a) for a in arrs], F)
    return out.reshape(-1), ok, [(f * F, f * F + fe[2])
                                 for f, fe in enumerate(frames_exec)]



# ---------------------------------------------------------------------------
# the transcode route
# ---------------------------------------------------------------------------

TRANSCODE_CHUNK = 16   # rows a chain runs before a mid-frame chunk start


def _block_guess(p: _FramePlan, fh) -> int:
    """The size assumed for a compressed block of frame `p` (its header
    does not give it).  The reference assumes 128 KiB (:979), right for
    libzstd's frames and the level <= 3 blocks, so its route falls back
    on every 64 KiB-block frame (levels >= 4).  A frame with an entry in
    the Writer's hints sidecar (`fh`, one record a block; usable or not)
    was written by this package's Writer or the JAX package's: equal
    blocks but the last, so its block is the power of two its block
    count implies."""
    if fh is None or len(fh) != len(p.blocks) or not p.blocks:
        return zf.BLOCK_MAX
    per = -(-p.content_size // len(p.blocks))
    return min(zf.BLOCK_MAX, _ceil_pow2(max(per, 1)))


def transcode_rows(plans, hints, fsereg: _FseReg,
                   host_literals: bool = True):
    """The transcode route's host half before the kernel (the reference's
    :966-1097): per frame its entries, ("host", d_off, bytes) for a
    literal-only block or ("row", row index, d_off, content) for a row
    of K4; and the rows (numpy): lp, sq, wtid, ftabs, meta (mode with
    DMODE_TRANSCODE, meta[1] the block's size, predicted where its header
    does not give it, meta[2] its offset in its frame), chain (rows from
    one DMODE_FRAME_START to the next), lit_prefix, tok_prefix, and
    blocks (each row's _BlockPlan, and whether its literals go to the
    device).  Returns None when a frame's sizes do not add up under the
    prediction (the batch goes to the fused route)."""
    frames = []
    rows = []     # (bp, content, d_off, mode, dev_lit, regen, splittable)
    for p, fh in zip(plans, hints):
        d_off = 0
        fstart = True
        usable = _frame_hints_usable(p, fh)
        guess = _block_guess(p, fh)
        fr = []
        for bp in p.blocks:
            if bp.lit_direct is not None and bp.n_seq == 0:
                fr.append(("host", d_off, bp.lit_direct))
                d_off += len(bp.lit_direct)
                continue
            content = bp.content if bp.content >= 0 else \
                min(guess, p.content_size - d_off)
            if content < 0:
                return None
            dev_lit = bool(bp.huf_lanes) and not host_literals
            regen = _lit_len(bp)
            if regen > zf.BLOCK_MAX:
                raise FormatError(f"block regenerates {regen} literal bytes")
            mode = D.DMODE_TRANSCODE | (D.DMODE_FRAME_START if fstart else 0)
            fr.append(("row", len(rows), d_off, content))
            rows.append((bp, content, d_off, mode, dev_lit, regen,
                         fstart or usable))
            fstart = False
            d_off += content
        if d_off != p.content_size:
            return None
        frames.append(fr)
    B = len(rows)
    meta = np.zeros((B, D.META_W), np.int32)
    wtid = np.zeros(B, np.int64)
    ftabs = np.zeros((B, 1536), np.int32)
    fse_packed = fsereg.packed()
    lit_w = np.zeros(B, np.int64)
    tok_w = np.zeros(B, np.int64)
    lp_list, sq_list, chain = [], [], []
    chunk = 0
    for i, (bp, content, d_off, mode, dev_lit, regen, split) in \
            enumerate(rows):
        # the reference's chunks (:1039-1043): one starts every
        # TRANSCODE_CHUNK rows where the row may start one (a frame's
        # first row, or any row of a frame with usable hints, whose
        # blocks keep their repcodes to themselves); a chunk start resets
        # the repcodes as a frame start does
        if i - chunk >= TRANSCODE_CHUNK and split:
            chunk = i
        if i == chunk:
            mode |= D.DMODE_FRAME_START
        if mode & D.DMODE_FRAME_START:    # chains split at every reset
            chain.append(i)
        bits, payload, seq = _pack_sections(i, bp, dev_lit, meta, wtid,
                                            ftabs, fse_packed)
        mode |= bits if dev_lit else bits | D.DMODE_DIRECT | D.DMODE_LIT_HOST
        lit_w[i] = (regen + 3) >> 2 if dev_lit else 0
        tok_w[i] = 2 * bp.n_seq
        lp_list.append(payload)
        sq_list.append(seq)
        meta[i, 0:4] = (mode, content, d_off, regen)
    chain.append(B)
    prefix = lambda w: np.concatenate([[0], np.cumsum(w)]).astype(np.int32)
    return dict(frames=frames, blocks=[(r[0], r[4]) for r in rows],
                lp=_words(lp_list), sq=_words(sq_list), wtid=wtid,
                ftabs=ftabs, meta=meta, chain=np.array(chain, np.int32),
                lit_prefix=prefix(lit_w), tok_prefix=prefix(tok_w))


def _host_literals(rows, hufreg: _HufReg) -> dict:
    """Huffman literals of the rows whose literals stay on the host,
    decoded by native huf_decode_batch in one call: {row: uint8 array}."""
    parts, lmeta, lane_out, spans = [], [], [], {}
    spos = opos = 0
    for r, (bp, dev_lit) in enumerate(rows["blocks"]):
        if dev_lit or not bp.huf_lanes:
            continue
        spans[r] = opos
        for lane in bp.huf_lanes:
            parts.append(lane.stream)
            lmeta.append((spos, len(lane.stream), lane.n_out, lane.tid))
            lane_out.append(opos)
            spos += len(lane.stream)
            opos += lane.n_out
    if not lmeta:
        return {}
    W, _ = hufreg.weights_arr()
    lits = native.huf_decode_batch(b"".join(parts),
                                   np.array(lmeta, np.int64), W, opos,
                                   np.array(lane_out, np.int64))
    return {r: lits[o: o + int(rows["meta"][r, 3])]
            for r, o in spans.items()}


def decode_frames_transcode(datas, d_sizes=None, hints=None, device="cuda",
                            host_literals: bool = True):
    """Decode a batch of zstd frames through the transcode route: K4's
    transcode arm on `device` emits each block's sequences as packed
    tokens, the host expands them (native zir_execute) into each frame's
    bytes.  Returns host `bytes` per frame.

    hints: per-frame decode anchors or None; a frame that has them is
    the Writer's (its block size is known), one whose anchors cover
    every block (usable) may start chunks mid-frame.  host_literals=False sends the Huffman literal
    streams to the device with the rows (the reference's ZN_HOSTLIT=off)
    instead of decoding them on the host.  A batch whose predicted block
    sizes do not add up, or whose kernel stat fails (an offset past the
    token's 2^28 - 1, a size off the prediction, a corrupt stream), goes
    to the fused route (decode_frames), counted in `routes`; a corrupt
    frame raises FormatError."""
    if not datas:
        return []
    if d_sizes is None:
        d_sizes = [None] * len(datas)
    if hints is None:
        hints = [None] * len(datas)
    dev = torch.device(device)
    with trace.span("zseek.parse"):
        hufreg, fsereg = _HufReg(), _FseReg()
        plans = [_parse_frame_impl(d, hufreg, fsereg, sz)
                 for d, sz in zip(datas, d_sizes)]
        rows = transcode_rows(plans, hints, fsereg, host_literals)
    if rows is None:
        _count_route("transcode_rule_batches")
        return decode_frames(datas, d_sizes, device=device)
    _count_route("transcode_batches")
    meta = rows["meta"]
    B = len(meta)
    res = None
    if B:
        with trace.span("zseek.upload"):
            up = lambda a: _tensor(a, dev)
            lp = dtabs = None     # no literal on the device: no payload
            if any(dev_lit for _, dev_lit in rows["blocks"]):
                W, TLS = hufreg.weights_arr()
                dtabs = build_dtabs(up(W), up(TLS)).index_select(
                    0, up(rows["wtid"])).contiguous()
                lp = up(rows["lp"])
            args = (lp, up(rows["sq"]), dtabs, up(rows["ftabs"]),
                    up(meta), up(rows["chain"]), up(rows["lit_prefix"]),
                    up(rows["tok_prefix"]))
        n_lit = int(rows["lit_prefix"][-1])
        n_tok = int(rows["tok_prefix"][-1])
        with trace.span("zseek.k4"):
            lits_d, toks_d, stat_d = D.transcode_blocks(*args, n_lit, n_tok)
            res = torch.cat([stat_d.reshape(-1), toks_d, lits_d])
    with trace.span("zseek.hostlit"):     # on the host while the kernel runs
        host_lits = _host_literals(rows, hufreg)
    if res is not None:
        with trace.span("zseek.fetch"):
            res = res.cpu().numpy()
        stat = res[: 4 * B].reshape(B, 4)
        if not ((stat[:, 1] == 1).all() and (stat[:, 0] == meta[:, 1]).all()):
            _count_route("transcode_fallback_batches")
            return decode_frames(datas, d_sizes, device=device)
        toks = res[4 * B: 4 * B + n_tok].view(np.uint32)
        dev_lits = res[4 * B + n_tok:].view(np.uint8)
    with trace.span("zseek.execute"):
        tp, lpre = rows["tok_prefix"], rows["lit_prefix"]
        out = []
        for p, fr in zip(plans, rows["frames"]):
            buf = np.empty(p.content_size, np.uint8)
            for e in fr:
                if e[0] == "host":
                    buf[e[1]: e[1] + len(e[2])] = np.frombuffer(e[2],
                                                               np.uint8)
                    continue
                _, r, d_off, content = e
                bp, dev_lit = rows["blocks"][r]
                if dev_lit:
                    lits = dev_lits[4 * lpre[r]: 4 * lpre[r] + meta[r, 3]]
                elif bp.huf_lanes:
                    lits = host_lits[r]
                else:
                    lits = np.frombuffer(bp.lit_direct or b"", np.uint8)
                if native.zir_execute(lits, toks[tp[r]: tp[r + 1]], buf,
                                      d_off) != content:
                    raise FormatError(f"block at {d_off} of a frame decodes "
                                      f"to a size other than {content}")
            out.append(buf.tobytes())
    return out
