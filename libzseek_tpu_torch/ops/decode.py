"""K4: fused zstd block decode (literals, sequences, repcodes, execution).

Counterpart of libzseek_tpu/ops/pallas_decode.py decode_blocks_smem
(:514), which runs the Pallas kernel _decode_kernel (:94, the pallas_call
at :543), in its execute mode (decode_blocks) and in its transcode mode
(transcode_blocks, below); its DMODE_* bits, META_W and the constant
table _CTAB (:79-91, LL/ML extra bits and baselines, rebuilt here from
the port's format/zstd_frame.py) keep their values.  The CUDA kernel is
csrc/decode.cu; the plain version below runs only for tensors on the CPU.

Inputs are the reference's packed rows, unchanged: lp_words (B, LPW)
int32 literal payload words (Huffman streams, or the literal bytes for
DMODE_DIRECT), sq_words (B, SQW) int32 sequence stream words, dtabs
(B, 4096) int32 Huffman peek tables (nb << 8 | sym), ftabs (B, 1536)
int32 LL | OF | ML FSE tables (sym | nb << 8 | base << 16) and meta (B, 16)
int32:

   0 mode | 1 block size if known, else -1 | 2 (not read) | 3 literals
   4..7 per-stream bits | 8..11 per-stream byte base | 12 sequence bits
   13 n_seq | 14 table logs (ll | of << 8 | ml << 16) | 15 spare

plus the chain layout: chain (F + 1,) int32, frame f owning rows
[chain[f], chain[f + 1]) in order, and frame_off (F + 1,) int64, its bytes
in the flat uint8 output.  Where the reference executes into a 256 KiB
ring with a word-aligned block base predicted on the host and offsets
below 128 KiB, the port writes every frame's bytes straight into the
output: a block starts where the previous one ended, and an offset may
reach back to the frame's first byte.

Returns (out (frame_off[-1],) uint8, stat (B, 4) int32 [advance, ok, 0,
0]).  ok = 0 marks a block whose streams are not consumed exactly, whose
offset, literal count or size leaves its frame or section, or whose
size differs from meta[1]; the rest of its chain is skipped (stat all 0).

The CUDA kernel decodes in phases (csrc/decode.cu): per-row records of
the sequence streams with symbolically resolved repcodes, a per-frame
composition of the rows' repcode transforms and placement, checks, and
execution by scatter and pointer doubling.  `row_records`, `compose`,
`exec_plan` and `decode_mirror` below mirror those phases in numpy and
Python ints; they are used only by the tests, which hold them to the
plain walk.

Transcode mode (transcode_blocks; DMODE_TRANSCODE, DMODE_LIT_HOST) reads
meta[2], each row's byte offset in its frame, and executes nothing: it
emits the literal bytes of rows whose literals are on the device and one
packed 2-word token a sequence for the host executor (native
zir_execute), into two dense int32 arrays (see transcode_blocks).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.format import zstd_frame as zf

DMODE_HUF4 = 1       # literal section: 4-stream Huffman
DMODE_HUF1 = 2       # literal section: 1-stream Huffman
DMODE_DIRECT = 4     # literal payload is the literal bytes themselves
DMODE_SEQ = 8        # block has a sequence section (n_seq > 0)
DMODE_FRAME_START = 16  # first block of a frame: reset repcode state
DMODE_TRANSCODE = 32    # emit literals and sequence tokens, execute nothing
DMODE_LIT_HOST = 64     # (transcode) the literals stay on the host
MAX_TOKEN_OFFSET = (1 << 28) - 1   # a token's offset field
HUF_PEEK = 12
META_W = 16
LIT_MAX = zf.BLOCK_MAX   # literals of one block (the kernel's scratch row)

# LL bits | LL baseline | ML bits | ML baseline (csrc/decode.cu C_* offsets)
CTAB = np.concatenate([zf.LL_BITS, zf.LL_BASELINE, zf.ML_BITS,
                       zf.ML_BASELINE]).astype(np.int32)
_N_LL = len(zf.LL_BITS)
_N_ML = len(zf.ML_BITS)
RI_W = 12                # csrc/decode.cu: a row's summary, int32
SYM = 1 << 40            # csrc/decode.cu: symbolic repcode slots
SYM_SH = 20

launches = 0             # execute mode (decode_blocks)
transcode_launches = 0   # transcode mode (transcode_blocks)
_count = threading.Lock()     # the codec decodes from two reader threads
_ctabs: dict = {}        # device -> CTAB there, copied once


def device_ctab(dev) -> torch.Tensor:
    """CTAB on `dev`, copied there once (a copy from pageable host memory
    waits for the stream): K4's arms and the sequence lanes read it."""
    t = _ctabs.get(dev)
    if t is None:
        with _count:
            t = _ctabs.get(dev)
            if t is None:
                t = _ctabs[dev] = torch.from_numpy(CTAB).to(dev)
    return t


def _check_rows(lp_words, sq_words, dtabs, ftabs, meta, *more) -> None:
    """Raise unless the packed rows and `more` (name, tensor, dtype,
    shape) are contiguous tensors of their dtype and shape on meta's
    device.  lp_words and dtabs may be None (transcode_blocks)."""
    B = meta.shape[0]
    dev = meta.device
    for name, t, dt, shape in (
            ("lp_words", lp_words, torch.int32,
             (B, lp_words.shape[-1] if lp_words is not None else 0)),
            ("sq_words", sq_words, torch.int32, (B, sq_words.shape[-1])),
            ("dtabs", dtabs, torch.int32, (B, 1 << HUF_PEEK)),
            ("ftabs", ftabs, torch.int32, (B, 1536)),
            ("meta", meta, torch.int32, (B, META_W)), *more):
        if t is None and name in ("lp_words", "dtabs"):
            continue
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ParameterError(f"K4: {name} must be a contiguous {dt} "
                                 f"{shape} tensor on {dev}")


def seq_total(meta) -> int:
    """The record count K4's scratch needs: the sum of meta[:, 13] over
    the rows (numpy), which the caller holds on the host."""
    return int(np.maximum(np.asarray(meta)[:, 13], 0).sum())


def decode_blocks(lp_words, sq_words, dtabs, ftabs, meta, chain, frame_off,
                  out_size: int, n_seqs: int | None = None):
    """Decode B zstd blocks in F frame chains; see the module docstring.
    `out_size` is frame_off[-1] and `n_seqs` is seq_total(meta): the
    caller knows both without a device sync.  The CUDA kernel sizes its
    record scratch from n_seqs (a row whose records would pass it
    fails); the plain version ignores it."""
    B, LPW = lp_words.shape
    SQW = sq_words.shape[1]
    F = chain.shape[0] - 1
    dev = lp_words.device
    _check_rows(lp_words, sq_words, dtabs, ftabs, meta,
                ("chain", chain, torch.int32, (F + 1,)),
                ("frame_off", frame_off, torch.int64, (F + 1,)))
    if dev.type == "cpu":
        return _decode_plain(lp_words, sq_words, dtabs, ftabs, meta, chain,
                             frame_off, out_size)
    if dev.type != "cuda":
        raise ParameterError(f"K4 runs on cuda or cpu tensors, not {dev}")
    if n_seqs is None:
        raise ParameterError("K4: n_seqs (seq_total of the host rows) sizes "
                             "the card's record scratch")
    return _decode_cuda(lp_words, sq_words, dtabs, ftabs, meta, chain,
                        frame_off, out_size, n_seqs)


def _decode_cuda(lp_words, sq_words, dtabs, ftabs, meta, chain, frame_off,
                 out_size, n_seqs):
    """The phased kernels of csrc/decode.cu on the rows' device."""
    global launches
    from libzseek_tpu_torch import kernels
    B, LPW = lp_words.shape
    SQW = sq_words.shape[1]
    F = chain.shape[0] - 1
    dev = lp_words.device
    if out_size >= 1 << 31 or n_seqs >= 1 << 31:
        raise ParameterError("K4: output and records must stay below 2^31")
    ctab = device_ctab(dev)
    rounds = max(1, int(out_size).bit_length())
    n = max(n_seqs, 1)
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    stat = torch.empty((B, 4), dtype=torch.int32, device=dev)
    lits = torch.empty((B, LIT_MAX), dtype=torch.uint8, device=dev)
    rec = torch.empty((n, 4), dtype=torch.int32, device=dev)
    sym = torch.empty(n, dtype=torch.int64, device=dev)
    res_off = torch.empty(n, dtype=torch.int32, device=dev)
    rinfo = torch.empty((B, RI_W), dtype=torch.int32, device=dev)
    xform = torch.empty((B, 3), dtype=torch.int64, device=dev)
    instate = torch.empty((B, 3), dtype=torch.int64, device=dev)
    srcs = torch.empty(max(out_size, 1), dtype=torch.int32, device=dev)
    changed = torch.empty(rounds, dtype=torch.int32, device=dev)
    kernels.launch(
        "zk_decode", dev, lp_words.data_ptr(), sq_words.data_ptr(),
        dtabs.data_ptr(), ftabs.data_ptr(), meta.data_ptr(), chain.data_ptr(),
        frame_off.data_ptr(), ctab.data_ptr(), B, F, LPW, SQW, n_seqs,
        out_size, rounds, lits.data_ptr(), out.data_ptr(), stat.data_ptr(),
        rec.data_ptr(), sym.data_ptr(), res_off.data_ptr(), rinfo.data_ptr(),
        xform.data_ptr(), instate.data_ptr(), srcs.data_ptr(),
        changed.data_ptr())
    with _count:
        launches += 1
    return out, stat


def transcode_blocks(lp_words, sq_words, dtabs, ftabs, meta, chain,
                     lit_prefix, tok_prefix, lit_words: int,
                     tok_words: int):
    """K4 in transcode mode: the entropy half of B blocks, nothing
    executed (the reference's DMODE_TRANSCODE / DMODE_LIT_HOST arms).

    lp_words, sq_words, dtabs, ftabs and meta are the packed rows of
    decode_blocks; every row's mode carries DMODE_TRANSCODE and meta[2] is
    its byte offset in its frame.  lp_words and dtabs may both be None
    when no row's literals are on the device (every row DMODE_LIT_HOST or
    without literals): the literal pass then does not run, and a row
    that asks for device literals fails.  chain (C + 1,) int32: chain c is rows
    [chain[c], chain[c + 1]), each starting at a DMODE_FRAME_START row
    (repcodes carry along a chain).  lit_prefix, tok_prefix (B + 1,)
    int32: row r's literal words start at lit_prefix[r] (a row whose
    literals are on the device: HUF4 or HUF1, or DIRECT without
    DMODE_LIT_HOST; (regen + 3) >> 2 words) and its 2 * n_seq token words
    at tok_prefix[r]; lit_words and tok_words are their last entries.

    Returns (lits (lit_words,) int32: each row's literal words, a
    Huffman row's last one zero past regen; toks (tok_words,) int32: w0 =
    ll | (ml & 0x3FFF) << 18, w1 = off | (ml >> 14) << 28 per sequence;
    stat (B, 4) int32
    [advance including the trailing literals, ok, 0, 0]).  ok = 0 for a
    Huffman stream or sequence stream not consumed exactly, or an offset
    outside [1, min(op + ll, 2^28 - 1)], op the sequence's position in its
    frame; a failing row still emits its tokens (check stat first)."""
    B, SQW = sq_words.shape
    C = chain.shape[0] - 1
    dev = meta.device
    if (lp_words is None) != (dtabs is None):
        raise ParameterError("K4: lp_words and dtabs are None together")
    _check_rows(lp_words, sq_words, dtabs, ftabs, meta,
                ("chain", chain, torch.int32, (C + 1,)),
                ("lit_prefix", lit_prefix, torch.int32, (B + 1,)),
                ("tok_prefix", tok_prefix, torch.int32, (B + 1,)))
    if dev.type == "cpu":
        return _transcode_plain(lp_words, sq_words, dtabs, ftabs, meta,
                                chain, lit_prefix, tok_prefix, lit_words,
                                tok_words)
    if dev.type != "cuda":
        raise ParameterError(f"K4 runs on cuda or cpu tensors, not {dev}")
    global transcode_launches
    # one buffer [stat | tokens | literal words] (the literals and, with
    # no literal pass, the stat zeroed by the library), and the scratch:
    # each row's repcode transform and symbolic count (B, 4), then its
    # symbolic offsets, two words at most a sequence
    out = torch.empty(4 * B + tok_words + lit_words, dtype=torch.int32,
                      device=dev)
    stat = out[: 4 * B].view(B, 4)
    toks = out[4 * B: 4 * B + tok_words]
    lits = out[4 * B + tok_words:]
    if B:
        from libzseek_tpu_torch import kernels
        scratch = torch.empty(4 * B + max(tok_words, 1), dtype=torch.int64,
                              device=dev)
        ptr = lambda t: t.data_ptr() if t is not None else None
        kernels.launch(
            "zk_transcode", dev, ptr(lp_words), sq_words.data_ptr(),
            ptr(dtabs), ftabs.data_ptr(), meta.data_ptr(), chain.data_ptr(),
            device_ctab(dev).data_ptr(), lit_prefix.data_ptr(),
            tok_prefix.data_ptr(), B, C,
            lp_words.shape[1] if lp_words is not None else 0, SQW, lit_words,
            lits.data_ptr(), toks.data_ptr(), stat.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + 32 * B)
        with _count:
            transcode_launches += 1
    return lits, toks, stat


# ---------------------------------------------------------------------------
# plain versions (CPU tensors): the kernels' walks, row by row in Python
# ---------------------------------------------------------------------------

class _Row:
    """Bit reads from one packed row of int32 words (csrc/decode.cu
    read_at / read_wide): absolute bit positions, zeros below bit 0."""

    def __init__(self, words: np.ndarray):
        self.b = words.astype("<i4").tobytes() + bytes(8)

    def read(self, a: int, nb: int) -> int:
        if nb <= 0:
            return 0
        if nb > 16:
            return self.read(a, 16) | (self.read(a + 16, nb - 16) << 16)
        mask = (1 << nb) - 1
        if a >= 0:
            q = a >> 3
            return (int.from_bytes(self.b[q: q + 4], "little")
                    >> (a & 7)) & mask
        return (int.from_bytes(self.b[0:4], "little") << min(-a, 31)) & mask


def _huf_literals(row: _Row, dt: list, m) -> tuple[bytearray, bool]:
    """The literal section of a Huffman row: (literal bytes, ok)."""
    mode, regen = int(m[0]), int(m[3])
    lits = bytearray(LIT_MAX)
    if regen > LIT_MAX:
        return lits, False
    if mode & DMODE_HUF4:
        per = (regen + 3) >> 2
        streams = [(s, s * per, per if s < 3 else max(regen - 3 * per, 0))
                   for s in range(4)]
    else:
        streams = [(0, 0, regen)]
    ok = True
    for s, dst, n in streams:
        pos = int(m[4 + s])
        base8 = int(m[8 + s]) * 8 - HUF_PEEK
        for i in range(n):
            e = dt[row.read(base8 + pos, HUF_PEEK)]
            pos -= e >> 8
            lits[dst + i] = e & 255
        ok &= pos == 0
    return lits, ok


def _decode_plain(lp_words, sq_words, dtabs, ftabs, meta, chain, frame_off,
                  out_size):
    lp = lp_words.numpy()
    sq = sq_words.numpy()
    mt = meta.numpy()
    ch = chain.numpy()
    fo = frame_off.numpy()
    B = lp.shape[0]
    out = np.zeros(out_size, np.uint8)
    stat = np.zeros((B, 4), np.int32)
    lit_rows: dict[int, bytearray] = {}
    for r in range(B):          # phase 1: literal sections, row by row
        ok = True
        if mt[r, 0] & (DMODE_HUF4 | DMODE_HUF1):
            lits, ok = _huf_literals(_Row(lp[r]), dtabs[r].tolist(), mt[r])
            lit_rows[r] = lits
        stat[r, 1] = int(ok)
    for f in range(len(ch) - 1):  # phase 2: each frame's chain in order
        fout = out[int(fo[f]): int(fo[f + 1])]
        fsize = len(fout)
        op = 0
        rep = [1, 4, 8]
        failed = False
        for r in range(int(ch[f]), int(ch[f + 1])):
            if failed:
                stat[r] = 0
                continue
            m = mt[r]
            mode, regen, n_seq = int(m[0]), int(m[3]), int(m[13])
            if mode & DMODE_FRAME_START:
                rep = [1, 4, 8]
            ok = bool(stat[r, 1])
            if mode & DMODE_DIRECT:
                lit = np.frombuffer(lp[r].astype("<i4").tobytes(), np.uint8)
                ok &= regen <= lit.shape[0]
            else:
                lit = np.frombuffer(lit_rows.get(r, bytes(LIT_MAX)),
                                    np.uint8)
            base = op
            lpos = 0
            if ok and mode & DMODE_SEQ and n_seq > 0:
                op, lpos, ok = _sequences(_Row(sq[r]), ftabs[r].tolist(), m,
                                          rep, lit, regen, fout, op)
            if ok:
                trail = max(regen - lpos, 0)
                if op + trail > fsize:
                    ok = False
                else:
                    fout[op: op + trail] = lit[lpos: lpos + trail]
                    op += trail
            adv = op - base
            if ok and m[1] >= 0 and adv != m[1]:
                ok = False
            stat[r] = (adv, int(ok), 0, 0)
            failed = not ok
    return torch.from_numpy(out), torch.from_numpy(stat)


def _rep_step(rep: list, ofv: int, ll: int) -> int:
    """The repcodes (RFC 8878 §3.1.1.5), concrete or symbolic: rep updated
    in place for offset value ofv; returns the offset, rep[0]."""
    r1, r2, r3 = rep
    idx = ofv + (1 if ll == 0 else 0)
    if ofv > 3:
        rep[:] = ofv - 3, r1, r2
    elif idx == 2:
        rep[:] = r2, r1, r3
    elif idx == 3:
        rep[:] = r3, r1, r2
    elif idx == 4:
        rep[:] = r1 - 1, r1, r2
    return rep[0]


class _SeqWalk:
    """The FSE sequence stream of one row, walked backward from bit
    meta[12] (csrc/decode.cu seq_open / seq_step): iterating yields each
    sequence's (ll, ml, off), the offset resolved against `rep` (updated
    in place).  The walk stops early at an offset code > 31; after it,
    `exact` says whether it ran to its end on bit 0 exactly."""

    def __init__(self, row: _Row, ft: list, m, rep: list):
        self.row, self.ft, self.m, self.rep = row, ft, m, rep
        self.exact = False

    def __iter__(self):
        row, ft, rep, c = self.row, self.ft, self.rep, CTAB
        n_seq = int(self.m[13])
        tlp = int(self.m[14])
        pos = int(self.m[12])
        states = []
        for tl in (tlp & 255, (tlp >> 8) & 255, (tlp >> 16) & 255):
            states.append(row.read(pos - tl, tl))
            pos -= tl
        s_ll, s_of, s_ml = states
        for t in range(n_seq):
            e_ll, e_of, e_ml = ft[s_ll], ft[512 + s_of], ft[1024 + s_ml]
            llc = min(e_ll & 255, _N_LL - 1)
            ofc = e_of & 255
            mlc = min(e_ml & 255, _N_ML - 1)
            if ofc > 31:
                return
            ofv = (1 << min(ofc, 30)) + row.read(pos - ofc, ofc)
            pos -= ofc
            mlb = int(c[2 * _N_LL + mlc])
            ml = int(c[2 * _N_LL + _N_ML + mlc]) + row.read(pos - mlb, mlb)
            pos -= mlb
            llb = int(c[llc])
            ll = int(c[_N_LL + llc]) + row.read(pos - llb, llb)
            pos -= llb
            _rep_step(rep, ofv, ll)
            if t < n_seq - 1:     # state updates: LL, ML, OF
                nb = (e_ll >> 8) & 255
                s_ll = (e_ll >> 16) + row.read(pos - nb, nb)
                pos -= nb
                nb = (e_ml >> 8) & 255
                s_ml = (e_ml >> 16) + row.read(pos - nb, nb)
                pos -= nb
                nb = (e_of >> 8) & 255
                s_of = (e_of >> 16) + row.read(pos - nb, nb)
                pos -= nb
            yield ll, ml, rep[0]
        self.exact = pos == 0


def _sequences(row: _Row, ft: list, m, rep: list, lit, regen: int, fout,
               op: int):
    """Walk one block's sequence stream and execute it into fout (the
    frame's bytes) from op.  Updates rep in place; returns (op, literals
    consumed, ok)."""
    fsize = len(fout)
    lpos = 0
    walk = _SeqWalk(row, ft, m, rep)
    for ll, ml, off in walk:
        if off < 1 or off > op + ll or lpos + ll > regen or \
                op + ll + ml > fsize:
            return op, lpos, False
        fout[op: op + ll] = lit[lpos: lpos + ll]
        d = op + ll
        if off >= ml:
            fout[d: d + ml] = fout[d - off: d - off + ml]
        else:
            fout[d: d + ml] = np.resize(fout[d - off: d], ml)
        op = d + ml
        lpos += ll
    return op, lpos, walk.exact


def _i32(v: int) -> int:
    """v wrapped to a signed 32-bit value (the kernel's int stores)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _transcode_literals(lp, dtabs, mt, lpre, lit_words):
    """Transcode mode's literal pass (huf_kernel), row by row: (the
    literal bytes, each row's verdict, stat with the pass's verdicts, or
    zeros where it does not run)."""
    B = mt.shape[0]
    lits = np.zeros(4 * lit_words, np.uint8)
    stat = np.zeros((B, 4), np.int32)
    lit_ok = np.ones(B, bool)
    for r in range(B):
        m = mt[r]
        mode, regen = int(m[0]), int(m[3])
        dst = 4 * int(lpre[r])
        if mode & DMODE_LIT_HOST:
            pass
        elif lp is None:        # no literal pass: nothing on the device
            lit_ok[r] = not mode & (DMODE_HUF4 | DMODE_HUF1 | DMODE_DIRECT)
        elif mode & (DMODE_HUF4 | DMODE_HUF1):
            row_lits, lit_ok[r] = _huf_literals(_Row(lp[r]),
                                                dtabs[r].tolist(), m)
            if regen <= LIT_MAX:
                lits[dst: dst + regen] = np.frombuffer(row_lits, np.uint8,
                                                       regen)
        elif mode & DMODE_DIRECT:
            lit_ok[r] = regen <= 4 * lp.shape[1]
            if lit_ok[r]:
                nb = 4 * ((regen + 3) >> 2)
                lits[dst: dst + nb] = lp[r].astype("<i4").view(
                    np.uint8)[:nb]
    if lp is not None:          # the literal pass's verdict
        stat[:, 1] = lit_ok
    return lits, lit_ok, stat


def _transcode_plain(lp_words, sq_words, dtabs, ftabs, meta, chain,
                     lit_prefix, tok_prefix, lit_words, tok_words):
    lp = lp_words.numpy() if lp_words is not None else None
    sq = sq_words.numpy()
    mt = meta.numpy()
    ch = chain.numpy()
    tpre = tok_prefix.numpy()
    toks = np.zeros(tok_words, np.int64)
    # phase 1: literal sections, row by row
    lits, lit_ok, stat = _transcode_literals(lp, dtabs, mt,
                                             lit_prefix.numpy(), lit_words)
    for c in range(len(ch) - 1):  # phase 2: each chain's rows in order
        rep = [1, 4, 8]
        for r in range(int(ch[c]), int(ch[c + 1])):
            m = mt[r]
            mode, regen, n_seq = int(m[0]), int(m[3]), int(m[13])
            if mode & DMODE_FRAME_START:
                rep = [1, 4, 8]
            ok = bool(lit_ok[r])
            base = int(m[2])
            op, lpos = base, 0
            if mode & DMODE_SEQ and n_seq > 0:
                op, lpos, seq_ok = _tokens(_Row(sq[r]), ftabs[r].tolist(), m,
                                           rep, toks, int(tpre[r]), op)
                ok &= seq_ok
            op += max(regen - lpos, 0)
            stat[r] = (_i32(op - base), int(ok), 0, 0)
    return (torch.from_numpy(lits.view("<i4").copy()),
            torch.from_numpy(toks.astype(np.uint32).view(np.int32)),
            torch.from_numpy(stat))


def _tokens(row: _Row, ft: list, m, rep: list, toks, t0: int, op: int):
    """Walk one block's sequence stream and write its packed tokens to
    toks[t0:] (uint32 values).  Updates rep in place; returns (op, literals
    consumed, ok)."""
    lpos = 0
    ok = True
    walk = _SeqWalk(row, ft, m, rep)
    for t, (ll, ml, off) in enumerate(walk):
        if off < 1 or off > min(op + ll, MAX_TOKEN_OFFSET):
            ok = False
        toks[t0 + 2 * t] = (ll | (ml & 0x3FFF) << 18) & 0xFFFFFFFF
        toks[t0 + 2 * t + 1] = (off | (ml >> 14) << 28) & 0xFFFFFFFF
        op += ll + ml
        lpos += ll
    return op, lpos, ok and walk.exact


# ---------------------------------------------------------------------------
# mirrors of the CUDA kernel's phases (tests only)
# ---------------------------------------------------------------------------

SYM_IN = [SYM, SYM + (1 << SYM_SH), SYM + (2 << SYM_SH)]


def resolve_sym(v: int, state) -> int:
    """A repcode slot or offset against a row's input repcodes: concrete
    values are themselves, SYM + (j << SYM_SH) - d is state[j] - d."""
    if v < SYM // 2:
        return v
    u = v - SYM
    j = (u + (1 << SYM_SH) - 1) >> SYM_SH
    return state[j] - ((j << SYM_SH) - u)


def row_records(sq_row, ft, m):
    """Phase 2 for one row: its sequence stream walked once with the
    repcodes symbolic (from SYM_IN).  Returns (records [(ll, ml, lpos,
    op, offset)], the walk {n_walk, exact, fail, op, lpos}, the row's
    repcode transform); fail is the first sequence past the literals or
    where an offset code > 31 stops the walk, else None."""
    regen, n_seq = int(m[3]), int(m[13])
    rep = list(SYM_IN)
    walk = _SeqWalk(_Row(sq_row), ft, m, rep)
    recs, op, lpos, fail = [], 0, 0, None
    for t, (ll, ml, off) in enumerate(walk):
        if fail is None and lpos + ll > regen:
            fail = t
        recs.append((ll, ml, lpos, op, off))
        op += ll + ml
        lpos += ll
    n = len(recs)
    if n < n_seq:
        fail = n if fail is None else min(fail, n)
    return recs, dict(n_walk=n, exact=walk.exact and n == n_seq, fail=fail,
                      op=op, lpos=lpos), rep


def compose(meta, chain, xforms, walks):
    """Phase 3a: each frame's rows in order, repcodes reset at
    DMODE_FRAME_START: (input repcodes per row, the row's place if every
    row before it succeeds)."""
    ins, bases = {}, {}
    for f in range(len(chain) - 1):
        st, base = [1, 4, 8], 0
        for r in range(int(chain[f]), int(chain[f + 1])):
            if int(meta[r][0]) & DMODE_FRAME_START:
                st = [1, 4, 8]
            ins[r], bases[r] = st, base
            st = [resolve_sym(v, ins[r]) for v in xforms[r]]
            w = walks[r]
            base += w["op"] + max(int(meta[r][3]) - w["lpos"], 0)
    return ins, bases


def exec_plan(meta, chain, frame_off, lit_ok, recs, walks, ins, bases,
              lpw):
    """Phases 3b-3c: every walked sequence's offset resolved and checked,
    then the serial walk's verdicts along each chain.  Returns (stat
    (B, 4): rows outside every chain keep [0, lit_ok, 0, 0]; {row:
    (sequences executed, trailing literals, offsets)} for every row the
    walk reaches)."""
    B = len(meta)
    stat = np.zeros((B, 4), np.int32)
    stat[:, 1] = lit_ok
    plan = {}
    for f in range(len(chain) - 1):
        fsz = int(frame_off[f + 1]) - int(frame_off[f])
        dead = False
        for r in range(int(chain[f]), int(chain[f + 1])):
            if dead:
                stat[r] = 0
                continue
            m = meta[r]
            mode, regen, n_seq = int(m[0]), int(m[3]), int(m[13])
            w, base = walks[r], bases[r]
            offs = [resolve_sym(q[4], ins[r]) for q in recs[r]]
            fail = w["fail"]
            for t, (ll, ml, lpos, op, _) in enumerate(recs[r]):
                o = offs[t]
                if o < 1 or o > base + op + ll or base + op + ll + ml > fsz:
                    fail = t if fail is None else min(fail, t)
                    break
            ok = bool(lit_ok[r])
            if mode & DMODE_DIRECT and regen > 4 * lpw:
                ok = False
            has = bool(mode & DMODE_SEQ) and n_seq > 0
            adv, nx, tr = 0, 0, 0
            if ok and has:
                if fail is not None and fail < n_seq:
                    ok, nx = False, fail
                    adv = recs[r][fail][3] if fail < w["n_walk"] else w["op"]
                else:
                    nx, adv = n_seq, w["op"]
                    ok = w["exact"]
            if ok:
                trail = max(regen - (w["lpos"] if has else 0), 0)
                if base + adv + trail > fsz:
                    ok = False
                else:
                    tr, adv = trail, adv + trail
            if ok and int(m[1]) >= 0 and adv != int(m[1]):
                ok = False
            stat[r] = (adv, int(ok), 0, 0)
            plan[r] = (nx, tr, offs)
            dead = not ok
    return stat, plan


def decode_mirror(lp_words, sq_words, dtabs, ftabs, meta, chain, frame_off,
                  out_size):
    """The CUDA kernel's phases on CPU tensors: literals, records,
    composition, checks and verdicts, then the literal scatter, each match
    byte's source index (folded back before the match) and pointer
    doubling.  Returns (out, stat) as decode_blocks does."""
    lp, sq, mt = lp_words.numpy(), sq_words.numpy(), meta.numpy()
    ch, fo = chain.numpy(), frame_off.numpy()
    B = lp.shape[0]
    lits, lit_ok = {}, np.ones(B, bool)
    for r in range(B):
        if mt[r, 0] & (DMODE_HUF4 | DMODE_HUF1):
            lits[r], lit_ok[r] = _huf_literals(_Row(lp[r]), dtabs[r].tolist(),
                                               mt[r])
    recs, walks, xforms = {}, {}, {}
    for r in range(B):
        if mt[r, 0] & DMODE_SEQ and mt[r, 13] > 0:
            recs[r], walks[r], xforms[r] = row_records(
                sq[r], ftabs[r].tolist(), mt[r])
        else:
            recs[r], walks[r], xforms[r] = [], dict(
                n_walk=0, exact=True, fail=None, op=0, lpos=0), SYM_IN
    ins, bases = compose(mt, ch, xforms, walks)
    stat, plan = exec_plan(mt, ch, fo, lit_ok, recs, walks, ins, bases,
                           lp.shape[1])
    out = np.zeros(out_size, np.uint8)
    srcs = np.full(out_size, -1, np.int64)
    for f in range(len(ch) - 1):
        for r in range(int(ch[f]), int(ch[f + 1])):
            if r not in plan:
                continue
            nx, tr, offs = plan[r]
            mode = int(mt[r, 0])
            lit = (np.frombuffer(lp[r].astype("<i4").tobytes(), np.uint8)
                   if mode & DMODE_DIRECT else
                   np.frombuffer(bytes(lits.get(r, bytes(LIT_MAX))),
                                 np.uint8))
            d0 = int(fo[f]) + bases[r]
            for t in range(nx):
                ll, ml, lpos, op, _ = recs[r][t]
                d = d0 + op
                out[d: d + ll] = lit[lpos: lpos + ll]
                j = np.arange(ml)
                o = offs[t]
                srcs[d + ll: d + ll + ml] = d + ll - o + (j % o if o < ml
                                                          else j)
            if tr:
                w = walks[r]
                out[d0 + w["op"]: d0 + w["op"] + tr] = \
                    lit[w["lpos"]: w["lpos"] + tr]
    while True:                 # pointer doubling to a fixpoint
        s = srcs[srcs >= 0]
        nxt = srcs.copy()
        idx = np.nonzero(srcs >= 0)[0]
        up = srcs[s] >= 0
        nxt[idx[up]] = srcs[s[up]]
        if np.array_equal(nxt, srcs):
            break
        srcs = nxt
    cp = srcs >= 0
    out[cp] = out[srcs[cp]]
    return torch.from_numpy(out), torch.from_numpy(stat)


TC_STAGE = 96 * 1024      # csrc/decode.cu: stream bytes a row walk stages


def tc_row_walk(sq_row, ft, m, base: int, stats: dict | None = None):
    """Transcode mode's phase 1 for one row (csrc/decode.cu tc_walk): its
    sequence stream walked once with the windowed step of the sequence
    lanes (testing/seq_mirror.py window_fields), its tables staged with
    ctab folded in, its repcodes symbolic from SYM_IN.  A step whose
    entries are WIDE, whose states lie outside [0, 512) or whose position
    lies past the row's last bit reads its entries from ft and its fields
    through _Row.read; an offset code > 31 stops the walk.  Returns
    (tokens [(w0, w1)]: w1 holds only ml's bits for a symbolic offset;
    symbolic [(offset, sequence, limit)]; {ok, op, lpos, rep}), ok the
    exact consumption, no stop and every concrete offset in [1,
    limit]."""
    from libzseek_tpu_torch.testing import seq_mirror as SM
    st = stats if stats is not None else {}
    for k in ("steps", "slow_steps", "wide_steps", "stops",
              "unstaged_rows", "symbolic"):
        st.setdefault(k, 0)
    trace = st.get("trace")     # a list: each step's states appended
    W = len(sq_row)
    row = _Row(sq_row)
    n_seq, tlp, pos = int(m[13]), int(m[14]), int(m[12])
    reach = min(W, max(pos, 0) // 32 + 2)
    raw = np.ascontiguousarray(sq_row, "<i4").view(np.uint8)
    staged = reach <= TC_STAGE // 4
    st["unstaged_rows"] += not staged
    word = SM._words(raw, reach if staged else W)
    tab = SM.stage(np.asarray(ft, np.int64), (0, 1, 2))
    s = []
    for tl in (tlp & 255, (tlp >> 8) & 255, (tlp >> 16) & 255):
        s.append(row.read(pos - tl, tl))
        pos -= tl
    s_ll, s_of, s_ml = s
    rep = list(SYM_IN)
    toks, syms = [], []
    ok, op, lpos, t = True, 0, 0, 0
    for t in range(n_seq):
        states = (s_ll, s_of, s_ml)
        if trace is not None:
            trace.append(states)
        fast = all(0 <= x < SM.FSE_TAB for x in states)
        if fast:
            ents = [tab[k][x] for k, x in enumerate(states)]
            fast = not any(y & SM.WIDE for _, y in ents) and pos <= 32 * W
        st["steps"] += 1
        if not fast:
            st["slow_steps"] += 1
            ents = [(e, SM.fold(k, e)) for k, e in enumerate(
                int(ft[k * SM.FSE_TAB + x]) for k, x in enumerate(states))]
            st["wide_steps"] += any(y & SM.WIDE for _, y in ents)
            if ents[1][0] & 255 > 31:   # an offset code > 31 stops the walk
                st["stops"] += 1
                break
        (ax, ay), (bx, _), (cx, cy) = ents
        upd = t < n_seq - 1
        counts = (bx & 255, (cy >> 24) & 31, (ay >> 24) & 31,
                  *((((x >> 8) & 255) if upd else 0) for x in (ax, cx, bx)))
        if fast:
            xo, xm, xl, yl, ym, yo = SM.window_fields(word, pos, counts)
        else:
            fields, p = [], pos
            for nb in counts:
                p -= nb
                fields.append(row.read(p, nb))
            xo, xm, xl, yl, ym, yo = fields
        pos -= sum(counts)
        ofv = (1 << min(counts[0], 30)) + xo
        ml = (cy & 0xFFFFFF) + xm
        ll = (ay & 0xFFFFFF) + xl
        off = _rep_step(rep, ofv, ll)
        if upd:
            s_ll = (ax >> 16) + yl
            s_ml = (cx >> 16) + ym
            s_of = (bx >> 16) + yo
        lim = min(base + op + ll, MAX_TOKEN_OFFSET)
        w1 = ((ml >> 14) << 28) & 0xFFFFFFFF
        if off < SYM // 2:
            ok = ok and 1 <= off <= lim
            w1 |= off & 0xFFFFFFFF
        else:
            syms.append((off, t, lim))
        toks.append(((ll | (ml & 0x3FFF) << 18) & 0xFFFFFFFF, w1))
        op += ll + ml
        lpos += ll
    else:
        t = n_seq
    st["symbolic"] += len(syms)
    ok = ok and t == n_seq and pos == 0
    return toks, syms, dict(ok=ok, op=op, lpos=lpos, rep=rep)


def transcode_mirror(lp_words, sq_words, dtabs, ftabs, meta, chain,
                     lit_prefix, tok_prefix, lit_words: int, tok_words: int,
                     stats: dict | None = None):
    """The CUDA transcode arm's phases on CPU tensors: the literal pass;
    T1, every row of a chain walked with symbolic repcodes (tc_row_walk);
    T2, each chain's transforms composed into its rows' input repcodes
    (compose); T3, every symbolic offset resolved (resolve_sym), checked
    and ORed into its token.  Returns (lits, toks, stat) as
    transcode_blocks does; `stats` gets tc_row_walk's counts."""
    lp = lp_words.numpy() if lp_words is not None else None
    sq, mt, ch = sq_words.numpy(), meta.numpy(), chain.numpy()
    tpre = tok_prefix.numpy()
    lits, lit_ok, stat = _transcode_literals(lp, dtabs, mt,
                                             lit_prefix.numpy(), lit_words)
    toks = np.zeros(tok_words, np.int64)
    rows = range(int(ch[0]), int(ch[-1])) if len(ch) > 1 else range(0)
    xforms, walks, syms, ok = {}, {}, {}, {}
    for r in rows:              # T1: every row at once
        m = mt[r]
        mode, regen, n_seq = int(m[0]), int(m[3]), int(m[13])
        w = dict(ok=True, op=0, lpos=0, rep=list(SYM_IN))
        syms[r] = []
        if mode & DMODE_SEQ and n_seq > 0:
            tk, syms[r], w = tc_row_walk(sq[r], ftabs[r].tolist(), m,
                                         int(m[2]), stats)
            for t, (w0, w1) in enumerate(tk):
                toks[int(tpre[r]) + 2 * t: int(tpre[r]) + 2 * t + 2] = w0, w1
        ok[r] = bool(lit_ok[r]) and w["ok"]
        stat[r] = (_i32(w["op"] + max(regen - w["lpos"], 0)), 0, 0, 0)
        xforms[r], walks[r] = w["rep"], w
    ins, _ = compose(mt, ch, xforms, walks)     # T2
    for r in rows:              # T3: the symbolic offsets
        for off, t, lim in syms[r]:
            o = resolve_sym(off, ins[r])
            ok[r] = ok[r] and 1 <= o <= lim
            toks[int(tpre[r]) + 2 * t + 1] |= o & 0xFFFFFFFF
        stat[r, 1] = ok[r]
    return (torch.from_numpy(lits.view("<i4").copy()),
            torch.from_numpy(toks.astype(np.uint32).view(np.int32)),
            torch.from_numpy(stat))
