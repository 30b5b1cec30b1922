"""K4: fused zstd block decode (literals, sequences, repcodes, execution).

Counterpart of libzseek_tpu/ops/pallas_decode.py decode_blocks_smem
(:514), which runs the Pallas kernel _decode_kernel (:94, the pallas_call
at :543), in its execute mode; its DMODE_* bits, META_W and the constant
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
HUF_PEEK = 12
META_W = 16
LIT_MAX = zf.BLOCK_MAX   # literals of one block (the kernel's scratch row)

# LL bits | LL baseline | ML bits | ML baseline (csrc/decode.cu C_* offsets)
CTAB = np.concatenate([zf.LL_BITS, zf.LL_BASELINE, zf.ML_BITS,
                       zf.ML_BASELINE]).astype(np.int32)
_N_LL = len(zf.LL_BITS)
_N_ML = len(zf.ML_BITS)

launches = 0
_count = threading.Lock()     # the codec decodes from two reader threads


def decode_blocks(lp_words, sq_words, dtabs, ftabs, meta, chain, frame_off,
                  out_size: int):
    """Decode B zstd blocks in F frame chains; see the module docstring.
    `out_size` is frame_off[-1] (the caller knows it without a device
    sync)."""
    B, LPW = lp_words.shape
    SQW = sq_words.shape[1]
    F = chain.shape[0] - 1
    dev = lp_words.device
    for name, t, dt, shape in (
            ("sq_words", sq_words, torch.int32, (B, SQW)),
            ("dtabs", dtabs, torch.int32, (B, 1 << HUF_PEEK)),
            ("ftabs", ftabs, torch.int32, (B, 1536)),
            ("meta", meta, torch.int32, (B, META_W)),
            ("chain", chain, torch.int32, (F + 1,)),
            ("frame_off", frame_off, torch.int64, (F + 1,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ParameterError(f"K4: {name} must be a contiguous {dt} "
                                 f"{shape} tensor on {dev}")
    if lp_words.dtype != torch.int32 or not lp_words.is_contiguous():
        raise ParameterError("K4: lp_words must be contiguous int32")
    if dev.type == "cpu":
        return _decode_plain(lp_words, sq_words, dtabs, ftabs, meta, chain,
                             frame_off, out_size)
    if dev.type != "cuda":
        raise ParameterError(f"K4 runs on cuda or cpu tensors, not {dev}")
    global launches
    from libzseek_tpu_torch import kernels
    lib = kernels.library()
    ctab = torch.from_numpy(CTAB).to(dev)
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    stat = torch.empty((B, 4), dtype=torch.int32, device=dev)
    lits = torch.empty((B, LIT_MAX), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.zk_decode(lp_words.data_ptr(), sq_words.data_ptr(),
                        dtabs.data_ptr(), ftabs.data_ptr(), meta.data_ptr(),
                        chain.data_ptr(), frame_off.data_ptr(),
                        ctab.data_ptr(), B, F, LPW, SQW, lits.data_ptr(),
                        out.data_ptr(), stat.data_ptr(), stream)
    kernels.check(err, "zk_decode")
    with _count:
        launches += 1
    return out, stat


# ---------------------------------------------------------------------------
# plain version (CPU tensors): the kernel's walk, row by row in Python
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


def _sequences(row: _Row, ft: list, m, rep: list, lit, regen: int, fout,
               op: int):
    """Walk one block's sequence stream and execute it into fout (the
    frame's bytes) from op.  Updates rep in place; returns (op, literals
    consumed, ok)."""
    n_seq = int(m[13])
    tlp = int(m[14])
    tl_ll, tl_of, tl_ml = tlp & 255, (tlp >> 8) & 255, (tlp >> 16) & 255
    fsize = len(fout)
    pos = int(m[12])
    s_ll = row.read(pos - tl_ll, tl_ll)
    pos -= tl_ll
    s_of = row.read(pos - tl_of, tl_of)
    pos -= tl_of
    s_ml = row.read(pos - tl_ml, tl_ml)
    pos -= tl_ml
    lpos = 0
    c = CTAB
    for t in range(n_seq):
        e_ll, e_of, e_ml = ft[s_ll], ft[512 + s_of], ft[1024 + s_ml]
        llc = min(e_ll & 255, _N_LL - 1)
        ofc = e_of & 255
        mlc = min(e_ml & 255, _N_ML - 1)
        if ofc > 31:
            return op, lpos, False
        ofv = (1 << min(ofc, 30)) + row.read(pos - ofc, ofc)
        pos -= ofc
        mlb = int(c[2 * _N_LL + mlc])
        ml = int(c[2 * _N_LL + _N_ML + mlc]) + row.read(pos - mlb, mlb)
        pos -= mlb
        llb = int(c[llc])
        ll = int(c[_N_LL + llc]) + row.read(pos - llb, llb)
        pos -= llb
        r1, r2, r3 = rep
        idx = ofv + (1 if ll == 0 else 0)
        if ofv > 3:
            rep[:] = ofv - 3, r1, r2
        elif idx == 1:
            pass
        elif idx == 2:
            rep[:] = r2, r1, r3
        elif idx == 3:
            rep[:] = r3, r1, r2
        else:
            rep[:] = r1 - 1, r1, r2
        off = rep[0]
        if off < 1 or off > op + ll or lpos + ll > regen or \
                op + ll + ml > fsize:
            return op, lpos, False
        if t < n_seq - 1:
            nb = (e_ll >> 8) & 255
            s_ll = (e_ll >> 16) + row.read(pos - nb, nb)
            pos -= nb
            nb = (e_ml >> 8) & 255
            s_ml = (e_ml >> 16) + row.read(pos - nb, nb)
            pos -= nb
            nb = (e_of >> 8) & 255
            s_of = (e_of >> 16) + row.read(pos - nb, nb)
            pos -= nb
        fout[op: op + ll] = lit[lpos: lpos + ll]
        d = op + ll
        if off >= ml:
            fout[d: d + ml] = fout[d - off: d - off + ml]
        else:
            fout[d: d + ml] = np.resize(fout[d - off: d], ml)
        op = d + ml
        lpos += ll
    return op, lpos, pos == 0
