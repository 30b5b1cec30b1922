"""Huffman and FSE lane decoders of the lane decode route.

Counterparts of four XLA `while_loop`s of libzseek_tpu/ops/zstd_decode.py
(not Pallas kernels): huf_decode_lanes (:401) and huf_decode_anchored
(:578) become `huf_lanes`, fse_decode_seq_lanes (:443) and
fse_decode_anchored (:620) become `seq_lanes`.  Each loop step of the
reference is a dozen gathers and selects over all lanes, and its
condition an `any(t < n)`: as torch ops on the card that is thousands of
tiny launches and a host sync per step, so each function is a CUDA kernel
(csrc/huf_lanes.cu, csrc/fse_lanes.cu, sharing csrc/lane_bits.cuh): the
anchored arms a thread a lane, the tables staged in shared memory and
the stream read through a register window; the tagged sequence arm a
block a lane, its stream staged too; the plain Huffman arm a block a
stream, cut into self-synchronising pieces.  Their numpy mirrors are
testing/huf_mirror.py and testing/seq_mirror.py.  The plain versions
below walk all lanes at once, vectorised over lanes like the reference's
loops, and run only for tensors on the CPU.

A lane reads one stream of a bank: (NS, SB) uint8, SB a multiple of 4,
each row a stream's bytes zero-padded (the reference's _win32 windows,
:56).  Bits are read as the reference's _read_at / _read_wide (:380-397):
the LE32 window at byte min(s0 >> 3, SB - 1) with s0 = max(start, 0),
bits below position 0 read as (w << min(-start, 31)) & mask, and a mask
of all ones for 32 bits or more (XLA's shift of 1 by >= 32 is 0).

Bound: the walks are chains of dependent loads (a table entry, then the
bits it sizes), so a lane is bound by their latency; the card hides it
only with enough lanes.  The anchored passes give thousands (one per 512
literals or 128 sequences), the tagged pass one per block.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import decode as D

HUF_PEEK = D.HUF_PEEK
REP_TAG = 1 << 20    # tagged rep value: -(k * REP_TAG + d) = frame rep k - d
FSE_TAB = 512        # entries of a packed FSE table (sym | nb << 8 | base << 16)

huf_launches = 0
seq_launches = 0
# the same launches by arm: pass A (plain) and A' (anchored); pass B
# (tagged) and B' (anchored)
huf_plain_launches = huf_anchored_launches = 0
seq_tagged_launches = seq_anchored_launches = 0
_count = threading.Lock()     # the Reader decodes from two threads


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != dev or not t.is_contiguous():
        raise ParameterError(f"{name} must be a contiguous {dtype} "
                             f"{tuple(shape)} tensor on {dev}")


def _check_bank(bank):
    if bank.dtype != torch.uint8 or bank.dim() != 2 or \
            bank.shape[1] % 4 or bank.shape[1] == 0 or \
            not bank.is_contiguous():
        raise ParameterError("bank must be a contiguous (NS, SB) uint8 "
                             "tensor with SB a positive multiple of 4")


def huf_lanes(bank, sid, bits, n, tid, dtabs, cap: int, exact: bool):
    """Decode Huffman lanes: lane l walks stream sid[l] of `bank` backward
    from bit bits[l] for n[l] <= cap symbols with table tid[l] of dtabs
    (T, 4096) int32 (nb << 8 | sym, 12-bit peek).

    Pass A (huf_decode_lanes): one lane per stream from its sentinel,
    exact=True, ok = every bit consumed (pos == 0).  Pass A'
    (huf_decode_anchored): one lane per anchored chunk, exact=False,
    ok = pos >= 0.  Returns (syms (L, cap) uint8, zero past n; ok (L,)
    bool)."""
    dev = bank.device
    _check_bank(bank)
    L = sid.shape[0]
    for name, t in (("sid", sid), ("bits", bits), ("n", n), ("tid", tid)):
        _check(name, t, torch.int32, (L,), dev)
    _check("dtabs", dtabs, torch.int32, (dtabs.shape[0], 1 << HUF_PEEK),
           dev)
    if cap < 1:
        raise ParameterError("cap must be >= 1")
    if dev.type == "cpu":
        return _huf_plain(bank, sid, bits, n, tid, dtabs, cap, exact)
    if dev.type != "cuda":
        raise ParameterError(f"huf_lanes runs on cuda or cpu, not {dev}")
    global huf_launches, huf_plain_launches, huf_anchored_launches
    from libzseek_tpu_torch import kernels
    syms = torch.zeros((L, cap), dtype=torch.uint8, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    if L:
        kernels.launch(
            "zk_huf_lanes", dev, bank.data_ptr(), sid.data_ptr(),
            bits.data_ptr(), n.data_ptr(), tid.data_ptr(), dtabs.data_ptr(),
            bank.shape[1], bank.shape[0], dtabs.shape[0], L, cap, int(exact),
            syms.data_ptr(), ok.data_ptr())
        with _count:
            huf_launches += 1
            if exact:
                huf_plain_launches += 1
            else:
                huf_anchored_launches += 1
    return syms, ok


def seq_lanes(bank, sid, bits, n, states, rep1, tids, tls, tabs, cap: int,
              tagged: bool):
    """Decode FSE sequence lanes: lane l walks stream sid[l] of `bank`
    backward from bit bits[l] for n[l] <= cap sequences with tables
    tids[l] = (LL, OF, ML) of tabs (T, 512) int32.

    Pass B (fse_decode_seq_lanes), tagged=True: bits is the stream's
    sentinel position, the initial states are read from the top with the
    logs tls[l] (0 = an RLE table, state 0), and the three repcodes are
    tagged (-(k * REP_TAG + d) = the frame's rep k at the block's start,
    minus d); ok = every bit consumed.  Pass B' (fse_decode_anchored),
    tagged=False: the chunk starts at the checkpoint (bits, states[l],
    rep1[l]) and resolves only rep1 (the encoder's streams use no other);
    ok = pos >= 0.  Extra bits are read OF, ML, LL; no state update after
    a lane's last sequence.  Returns (ll, ml, off (L, cap) int32, zero past
    n; rep_final (L, 3) int32; ok (L,) bool)."""
    dev = bank.device
    _check_bank(bank)
    L = sid.shape[0]
    for name, t in (("sid", sid), ("bits", bits), ("n", n),
                    ("rep1", rep1)):
        _check(name, t, torch.int32, (L,), dev)
    for name, t in (("states", states), ("tids", tids), ("tls", tls)):
        _check(name, t, torch.int32, (L, 3), dev)
    _check("tabs", tabs, torch.int32, (tabs.shape[0], FSE_TAB), dev)
    if cap < 1:
        raise ParameterError("cap must be >= 1")
    if dev.type == "cpu":
        return _seq_plain(bank, sid, bits, n, states, rep1, tids, tls, tabs,
                          cap, tagged)
    if dev.type != "cuda":
        raise ParameterError(f"seq_lanes runs on cuda or cpu, not {dev}")
    global seq_launches, seq_tagged_launches, seq_anchored_launches
    from libzseek_tpu_torch import kernels
    ctab = D.device_ctab(dev)
    ll = torch.zeros((L, cap), dtype=torch.int32, device=dev)
    ml = torch.zeros((L, cap), dtype=torch.int32, device=dev)
    off = torch.zeros((L, cap), dtype=torch.int32, device=dev)
    rep = torch.empty((L, 3), dtype=torch.int32, device=dev)
    ok = torch.empty(L, dtype=torch.bool, device=dev)
    if L:
        kernels.launch(
            "zk_fse_lanes", dev, bank.data_ptr(), sid.data_ptr(),
            bits.data_ptr(), n.data_ptr(), states.data_ptr(), rep1.data_ptr(),
            tids.data_ptr(), tls.data_ptr(), tabs.data_ptr(), ctab.data_ptr(),
            bank.shape[1], bank.shape[0], tabs.shape[0], L, cap, int(tagged),
            ll.data_ptr(), ml.data_ptr(), off.data_ptr(), rep.data_ptr(),
            ok.data_ptr())
        with _count:
            seq_launches += 1
            if tagged:
                seq_tagged_launches += 1
            else:
                seq_anchored_launches += 1
    return ll, ml, off, rep, ok


# ---------------------------------------------------------------------------
# plain versions (CPU tensors): the reference's loops, vectorised over lanes
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values to int32's range, as XLA's int32 arithmetic."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _windows(bank: torch.Tensor) -> torch.Tensor:
    """(NS, SB) uint8 -> flat (NS * SB,) int64 LE32 windows, zero past
    each row's end (_win32)."""
    a = torch.nn.functional.pad(bank.to(torch.int64), (0, 3))
    w = a[:, :-3] | (a[:, 1:-2] << 8) | (a[:, 2:-1] << 16) | (a[:, 3:] << 24)
    return w.reshape(-1)


class _Reader:
    """_read_at / _read_wide against a flat window bank, per lane."""

    def __init__(self, bank, sid):
        self.win = _windows(bank)
        self.SB = bank.shape[1]
        self.base = sid.to(torch.int64) * self.SB

    def read(self, start, nb):
        s0 = start.clamp(min=0)
        w = self.win[self.base + torch.clamp(s0 >> 3, max=self.SB - 1)] \
            >> (s0 & 7)
        mask = torch.where(nb >= 32, torch.full_like(nb, _M32),
                           (torch.ones_like(nb) << nb.clamp(0, 32)) - 1)
        under = (-start).clamp(0, 31)
        return torch.where(start >= 0, w & mask, ((w << under) & _M32) & mask)

    def wide(self, start, nb):
        lo_nb = nb.clamp(max=16)
        lo = self.read(start, lo_nb)
        hi = self.read(start + 16, nb - lo_nb)
        return (lo | (hi << 16)) & _M32


def _huf_plain(bank, sid, bits, n, tid, dtabs, cap, exact):
    L = sid.shape[0]
    rd = _Reader(bank, sid)
    flat = dtabs.reshape(-1).to(torch.int64)
    tbase = tid.to(torch.int64) << HUF_PEEK
    pos = bits.to(torch.int64)
    cnt = n.to(torch.int64)
    peek = torch.full((L,), HUF_PEEK, dtype=torch.int64)
    syms = torch.zeros((L, cap), dtype=torch.uint8)
    steps = min(cap, int(cnt.max())) if L else 0
    for t in range(steps):
        active = t < cnt
        v = rd.read(pos - HUF_PEEK, peek)
        ent = flat[(tbase + v).clamp(0, flat.numel() - 1)]
        syms[:, t] = torch.where(active, ent & 255, 0).to(torch.uint8)
        pos = torch.where(active, pos - (ent >> 8), pos)
    ok = pos == 0 if exact else pos >= 0
    return syms, ok


_LL_BITS = torch.tensor(zf.LL_BITS, dtype=torch.int64)
_LL_BASE = torch.tensor(zf.LL_BASELINE, dtype=torch.int64)
_ML_BITS = torch.tensor(zf.ML_BITS, dtype=torch.int64)
_ML_BASE = torch.tensor(zf.ML_BASELINE, dtype=torch.int64)


def _seq_plain(bank, sid, bits, n, states, rep1, tids, tls, tabs, cap,
               tagged):
    L = sid.shape[0]
    rd = _Reader(bank, sid)
    flat = tabs.reshape(-1).to(torch.int64)
    last = flat.numel() - 1
    tb = tids.to(torch.int64) * FSE_TAB
    cnt = n.to(torch.int64)
    pos = bits.to(torch.int64)
    if tagged:
        tl = tls.to(torch.int64)
        st = []
        for k in range(3):
            st.append(rd.read(pos - tl[:, k], tl[:, k]))
            pos = pos - tl[:, k]
        s_ll, s_of, s_ml = st
        r1 = torch.full((L,), -REP_TAG, dtype=torch.int64)
        r2 = torch.full((L,), -2 * REP_TAG, dtype=torch.int64)
        r3 = torch.full((L,), -3 * REP_TAG, dtype=torch.int64)
    else:
        s_ll, s_of, s_ml = (states[:, k].to(torch.int64) for k in range(3))
        r1 = rep1.to(torch.int64)
        r2 = torch.zeros(L, dtype=torch.int64)
        r3 = torch.zeros(L, dtype=torch.int64)
    out = [torch.zeros((L, cap), dtype=torch.int32) for _ in range(3)]
    zero = torch.zeros(L, dtype=torch.int64)

    def ent(k, s):
        return flat[(tb[:, k] + s).clamp(0, last)]

    steps = min(cap, int(cnt.max())) if L else 0
    for t in range(steps):
        active = t < cnt
        e_ll, e_of, e_ml = ent(0, s_ll), ent(1, s_of), ent(2, s_ml)
        llc, ofc, mlc = e_ll & 255, e_of & 255, e_ml & 255
        of_extra = _i32(rd.wide(pos - ofc, ofc))
        pos = torch.where(active, pos - ofc, pos)
        ofv = _i32((torch.ones_like(ofc) << ofc.clamp(max=30)) + of_extra)
        mlc = mlc.clamp(max=zf.MAX_ML_CODE)
        mlb = _ML_BITS[mlc]
        ml = _ML_BASE[mlc] + rd.read(pos - mlb, mlb)
        pos = torch.where(active, pos - mlb, pos)
        llc = llc.clamp(max=zf.MAX_LL_CODE)
        llb = _LL_BITS[llc]
        ll = _LL_BASE[llc] + rd.read(pos - llb, llb)
        pos = torch.where(active, pos - llb, pos)
        if tagged:
            idx = _i32(ofv + (ll == 0).to(torch.int64))
            off = torch.where(ofv > 3, ofv - 3,
                              torch.where(idx == 1, r1,
                                          torch.where(idx == 2, r2,
                                                      torch.where(idx == 3,
                                                                  r3,
                                                                  r1 - 1))))
            n_r2 = torch.where(ofv > 3, r1, torch.where(idx == 1, r2, r1))
            n_r3 = torch.where(ofv > 3, r2,
                               torch.where((idx == 1) | (idx == 2), r3, r2))
            r2 = torch.where(active, n_r2, r2)
            r3 = torch.where(active, n_r3, r3)
        else:
            off = torch.where(ofv > 3, ofv - 3, r1)
        r1 = torch.where(active, off, r1)
        upd = active & (t < cnt - 1)
        nb = (e_ll >> 8) & 255
        s_ll_n = (e_ll >> 16) + rd.read(pos - nb, nb)
        pos = torch.where(upd, pos - nb, pos)
        nb = (e_ml >> 8) & 255
        s_ml_n = (e_ml >> 16) + rd.read(pos - nb, nb)
        pos = torch.where(upd, pos - nb, pos)
        nb = (e_of >> 8) & 255
        s_of_n = (e_of >> 16) + rd.read(pos - nb, nb)
        pos = torch.where(upd, pos - nb, pos)
        s_ll = torch.where(upd, s_ll_n, s_ll)
        s_ml = torch.where(upd, s_ml_n, s_ml)
        s_of = torch.where(upd, s_of_n, s_of)
        for o, v in zip(out, (ll, ml, off)):
            o[:, t] = torch.where(active, v, zero).to(torch.int32)
    rep = torch.stack([r1, r2, r3], 1).to(torch.int32)
    ok = pos == 0 if tagged else pos >= 0
    return out[0], out[1], out[2], rep, ok


def stream_bank(streams: list[bytes], pad: int = 4) -> np.ndarray:
    """(NS, SB) uint8 rows of `streams`, zero-padded to the reference's
    SB = max(4, ceil_pow2(longest + pad))."""
    longest = max((len(s) for s in streams), default=0)
    SB = max(4, 1 << max(0, (longest + pad - 1).bit_length()))
    bank = np.zeros((len(streams), SB), np.uint8)
    for i, s in enumerate(streams):
        bank[i, : len(s)] = np.frombuffer(s, np.uint8)
    return bank
