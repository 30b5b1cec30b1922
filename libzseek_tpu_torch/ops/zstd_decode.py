"""zstd frame decode: host container parse and the fused route around K4.

Counterpart of the host half of libzseek_tpu/ops/zstd_decode.py that its
fused route uses:

  host   — frame and block headers, literal-section headers, Huffman
           weight and FSE table descriptions (_parse_frame_impl :336,
           _parse_lit_section :220, _parse_seq_section :290), deduplicated
           into table registries (_HufReg :69 without its XLA-lane
           packed(), _FseReg :141), then packed into K4's rows as
           _try_decode_smem does (:788-871);
  device — build_dtabs (the jitted _build_dtabs, :117-138, as torch ops)
           and K4 (ops/decode.py, csrc/decode.cu).

Every RFC 8878 block, literal and table mode is parsed (raw, RLE,
compressed and treeless literals; predefined, RLE, compressed and repeat
FSE tables), so frames written by stock libzstd decode too.  Not ported:
the XLA lane passes (:380-749), the hint-anchored lanes and the
transcode route (:948); see ROADMAP.md.  Unlike _try_decode_smem, the
packer predicts no block sizes: K4 places each block where the previous
one ended, checks a block's size only where its header gives it (raw
and RLE blocks, meta[1]; -1 otherwise) and decode_frames checks each
frame's total against its content size.  There is no second route: a
block K4 rejects raises FormatError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import fse
from libzseek_tpu_torch.ops import huffman

_HUF_PEEK = D.HUF_PEEK  # libzstd's HUF_TABLELOG_MAX: accept 12-bit tables
# profiler ranges around the read path's stages (free when no profiler
# runs; read by libzseek_tpu_torch/profile_write.py)
_span = torch.profiler.record_function


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
    padded to 512 entries."""

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
    fse_packed = np.stack(fsereg.tables) if fsereg.tables else None
    chain = np.zeros(len(plans) + 1, np.int32)
    frame_off = np.zeros(len(plans) + 1, np.int64)
    lp_list: list[bytes] = []
    sq_list: list[bytes] = []
    i = 0
    for f, p in enumerate(plans):
        chain[f] = i
        frame_off[f + 1] = frame_off[f] + p.content_size
        for bi, bp in enumerate(p.blocks):
            mode = D.DMODE_FRAME_START if bi == 0 else 0
            regen = 0
            payload = b""
            if bp.huf_lanes:
                lanes = bp.huf_lanes
                regen = sum(l.n_out for l in lanes)
                mode |= D.DMODE_HUF1 if len(lanes) == 1 else D.DMODE_HUF4
                off = 0
                for s, l in enumerate(lanes):
                    meta[i, 4 + s] = _sentinel_bits(l.stream)
                    meta[i, 8 + s] = off
                    off += len(l.stream)
                payload = b"".join(l.stream for l in lanes)
                wtid[i] = lanes[0].tid
            elif bp.lit_direct is not None:
                mode |= D.DMODE_DIRECT
                payload = bp.lit_direct
                regen = len(payload)
            if regen > zf.BLOCK_MAX:
                raise FormatError(f"block regenerates {regen} literal bytes")
            if bp.n_seq > 0:
                mode |= D.DMODE_SEQ
                meta[i, 12] = _sentinel_bits(bp.seq_stream)
                meta[i, 13] = bp.n_seq
                meta[i, 14] = bp.ll_tl | (bp.of_tl << 8) | (bp.ml_tl << 16)
                ftabs[i, 0:512] = fse_packed[bp.ll_tid]
                ftabs[i, 512:1024] = fse_packed[bp.of_tid]
                ftabs[i, 1024:1536] = fse_packed[bp.ml_tid]
                sq_list.append(bp.seq_stream)
            else:
                sq_list.append(b"")
            lp_list.append(payload)
            meta[i, 0] = mode
            meta[i, 1] = bp.content
            meta[i, 3] = regen
            i += 1
    chain[-1] = B
    LPW = _round_words(max(map(len, lp_list), default=0))
    SQW = _round_words(max(map(len, sq_list), default=0))
    lp = np.zeros((B, 4 * LPW), np.uint8)
    sq = np.zeros((B, 4 * SQW), np.uint8)
    for r in range(B):
        lp[r, : len(lp_list[r])] = np.frombuffer(lp_list[r], np.uint8)
        sq[r, : len(sq_list[r])] = np.frombuffer(sq_list[r], np.uint8)
    return dict(lp=lp.view("<i4"), sq=sq.view("<i4"), wtid=wtid, ftabs=ftabs,
                meta=meta, chain=chain, frame_off=frame_off,
                payload_bytes=sum(map(len, lp_list)) + sum(map(len, sq_list)))


def k4_inputs(datas, d_sizes, device) -> tuple[tuple, int, dict]:
    """Parse and pack frames, upload the rows to `device` and build their
    Huffman tables there: (K4's arguments, out_size, the packed rows)."""
    with _span("zseek.parse"):
        hufreg, fsereg = _HufReg(), _FseReg()
        plans = [_parse_frame_impl(d, hufreg, fsereg, sz)
                 for d, sz in zip(datas, d_sizes)]
        rows = pack_rows(plans, hufreg, fsereg)
    with _span("zseek.upload"):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        W, TLS = hufreg.weights_arr()
        dtabs = build_dtabs(t(W), t(TLS)).index_select(0, t(rows["wtid"]))
        args = (t(rows["lp"]), t(rows["sq"]), dtabs.contiguous(),
                t(rows["ftabs"]), t(rows["meta"]), t(rows["chain"]),
                t(rows["frame_off"]))
    return args, int(rows["frame_off"][-1]), rows


def decode_frames(datas, d_sizes=None, to_device: bool = False,
                  device="cpu"):
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
    with _span("zseek.k4"):
        out, stat = D.decode_blocks(*args, out_size)
    with _span("zseek.fetch"):
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
    with _span("zseek.fetch"):
        host = out.cpu().numpy()
        return [host[frame_off[f]: frame_off[f + 1]].tobytes()
                for f in range(len(datas))]
