"""The reference's XLA entropy arm: 4-stream Huffman literals and FSE
sequences with the predefined tables, as torch ops.

Counterparts in libzseek_tpu/ops/zstd_encode.py: ll_code_dev (:59),
ml_code_dev (:69), huffman_encode_literals (:163), _enc_tables_dev (:232)
and fse_encode_sequences (:242).  These are not Pallas kernels; the codec
takes this arm for batches whose largest gated block holds more than
SMEM_SEQ_MAX sequences, or with entropy="xla".

Every emission's bit offset is a prefix sum, so the streams are packed by
one scatter (ops/bits.py) on the batch's device.  The one sequential part
is the 3-state tANS walk over sequences (the reference's lax.scan, :308):
a torch loop on the card would launch kernels for every sequence, so it
is a host walk, sequential over sequences and vectorised over rows, as
_rep1_rewrite's is (ops/zstd_encode.py): the per-sequence codes come to
the host once, the states and state bits go back once.
"""

from __future__ import annotations

import numpy as np
import torch

from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import bits as BITS
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops import fse
from libzseek_tpu_torch.ops.entropy import exp_of

# the predefined FSE encode tables (_enc_tables_dev), (state_table,
# delta_nb_bits, delta_find_state) as int64 numpy arrays for the host walk,
# in LL, OF, ML order
_ENC_TABLES = [tuple(np.asarray(a, np.int64) for a in (
    et.state_table, et.delta_nb_bits, et.delta_find_state))
    for et in (fse.build_encode_table(nm, lg) for nm, lg in (
        (zf.LL_DEFAULT_NORM, zf.LL_DEFAULT_LOG),
        (zf.OF_DEFAULT_NORM, zf.OF_DEFAULT_LOG),
        (zf.ML_DEFAULT_NORM, zf.ML_DEFAULT_LOG)))]


def _const(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def ll_code_dev(ll: torch.Tensor) -> torch.Tensor:
    """Literal-length codes: a compare-count below 64, log2 above."""
    base = _const(zf._LL_BASE[16:], ll.device)
    small = torch.where(ll < 16, ll.to(torch.int64),
                        15 + (ll[..., None] >= base).sum(-1))
    return torch.where(ll > 63, exp_of(torch.clamp(ll, min=1)).to(
        torch.int64) + 19, small).to(torch.int32)


def ml_code_dev(ml: torch.Tensor) -> torch.Tensor:
    """Match-length codes (ml >= 3): a compare-count below 131, log2
    above."""
    mb = ml - 3
    base = _const(zf._ML_BASE[32:], ml.device)
    small = torch.where(mb < 32, mb.to(torch.int64),
                        31 + (ml[..., None] >= base).sum(-1))
    return torch.where(mb > 127, exp_of(torch.clamp(mb, min=1)).to(
        torch.int64) + 36, small).to(torch.int32)


def huffman_encode_literals(lits: torch.Tensor, lit_count: torch.Tensor,
                            code_vals: torch.Tensor, code_bits: torch.Tensor,
                            out_bytes: int, anchor_interval: int = 0,
                            return_words: bool = False):
    """4-stream Huffman encode of compacted literals lits (B, LC) uint8
    with per-row codes code_vals / code_bits (B, 256).  Returns (streams
    (B, out_bytes) uint8, or (B, out_bytes // 4) int32 words with
    return_words, stream byte sizes (B, 4) int32); with anchor_interval A
    > 0 also the decode anchors (B, 4, MAXA) int32, the decoder's bit
    position in each stream after every A symbols, -1 where absent."""
    B, LC = lits.shape
    dev = lits.device
    i64 = torch.int64
    idx = torch.arange(LC, device=dev)[None, :]
    lc = lit_count.to(i64)
    active = idx < lc[:, None]
    li = lits.to(i64)
    cv = C.take1(code_vals.to(i64), li)
    cb = torch.where(active, C.take1(code_bits.to(i64), li),
                     torch.zeros_like(li))
    s = (lc + 3) >> 2
    sid = torch.clamp(idx // torch.clamp(s, min=1)[:, None], max=3)
    cum = torch.cumsum(cb, 1)
    start_all = cum - cb
    zero = torch.zeros_like(s)
    stream_start = torch.stack([zero, s, 2 * s, 3 * s], 1)
    cum_pad = torch.nn.functional.pad(cum, (1, 0))
    cum0 = C.take1(cum_pad, torch.clamp(stream_start, 0, LC))
    fwd = start_all - C.take1(cum0, sid)
    end_idx = torch.stack([s, 2 * s, 3 * s, lc], 1)
    stream_bits = C.take1(cum_pad, torch.clamp(end_idx, 0, LC)) - cum0
    # emitted in reverse within each stream: the decoder reads backward
    in_stream = C.take1(stream_bits, sid) - fwd - cb
    sizes = (stream_bits + 1 + 7) >> 3
    base = C.exclusive_cumsum(sizes, dim=1)
    abs_pos = (C.take1(base, sid) << 3) + in_stream
    sent_pos = (base << 3) + stream_bits
    ones = torch.ones((B, 4), dtype=i64, device=dev)
    words = BITS.pack_bits_at(torch.cat([cv, ones], 1),
                              torch.cat([cb, ones], 1),
                              torch.cat([abs_pos, sent_pos], 1),
                              out_bytes // 4)
    streams = words if return_words else \
        BITS.words_to_bytes(words, out_bytes)
    sizes = sizes.to(torch.int32)
    if not anchor_interval:
        return streams, sizes
    A = anchor_interval
    maxa = ((LC + 3) // 4 + A - 1) // A
    m = (torch.arange(1, maxa + 1, device=dev) * A)[None, None, :]
    counts = torch.stack([s, s, s, lc - 3 * s], 1)
    valid = m < counts[:, :, None]
    idx_a = torch.clamp(stream_start[:, :, None] + m, 0, LC)
    consumed = C.take1(cum_pad, idx_a.reshape(B, -1)).reshape(B, 4, maxa) \
        - cum0[:, :, None]
    anchors = torch.where(valid, stream_bits[:, :, None] - consumed,
                          torch.full_like(consumed, -1))
    return streams, sizes, anchors.to(torch.int32)


def _state_walk(r_llc, r_mlc, r_ofc, first, later):
    """The 3-state tANS walk over encode steps (B, S) on the host: per step
    the state bits (OF, ML, LL values and counts, zero where the step
    emits none) and the states after it (LL, OF, ML), each (B, S, 3)
    int64, and the final states."""
    (ll_st, ll_dnb, ll_dfs), (of_st, of_dnb, of_dfs), \
        (ml_st, ml_dnb, ml_dfs) = _ENC_TABLES
    a = [t.cpu().numpy().astype(np.int64) for t in (r_llc, r_mlc, r_ofc)]
    fst, lat = first.cpu().numpy(), later.cpu().numpy()
    B, S = fst.shape
    act = fst | lat
    steps = int(act.any(0).nonzero()[0].max()) + 1 if act.any() else 0

    def enc(state, sym, st, dnb, dfs):
        nb = (state + dnb[sym]) >> 16
        bits_v = state & ((1 << np.clip(nb, 0, 31)) - 1)
        new = st[np.clip((state >> np.clip(nb, 0, 31)) + dfs[sym], 0,
                         len(st) - 1)]
        return new, bits_v, nb

    def init(sym, st, dnb, dfs):
        nb = (dnb[sym] + (1 << 15)) >> 16
        v = (nb << 16) - dnb[sym]
        return st[(v >> nb) + dfs[sym]]

    sb = np.zeros((S, 3, B), np.int64)
    sn = np.zeros((S, 3, B), np.int64)
    stt = np.zeros((S, 3, B), np.int64)
    s_ll = np.zeros(B, np.int64)
    s_of = np.zeros(B, np.int64)
    s_ml = np.zeros(B, np.int64)
    for t in range(steps):
        llc, mlc, ofc = a[0][:, t], a[1][:, t], a[2][:, t]
        f, lt = fst[:, t], lat[:, t]
        n_of, bv_of, nb_of = enc(s_of, ofc, of_st, of_dnb, of_dfs)
        n_ml, bv_ml, nb_ml = enc(s_ml, mlc, ml_st, ml_dnb, ml_dfs)
        n_ll, bv_ll, nb_ll = enc(s_ll, llc, ll_st, ll_dnb, ll_dfs)
        s_ll = np.where(f, init(llc, ll_st, ll_dnb, ll_dfs),
                        np.where(lt, n_ll, s_ll))
        s_of = np.where(f, init(ofc, of_st, of_dnb, of_dfs),
                        np.where(lt, n_of, s_of))
        s_ml = np.where(f, init(mlc, ml_st, ml_dnb, ml_dfs),
                        np.where(lt, n_ml, s_ml))
        sb[t] = np.where(lt, [bv_of, bv_ml, bv_ll], 0)
        sn[t] = np.where(lt, [nb_of, nb_ml, nb_ll], 0)
        stt[t] = s_ll, s_of, s_ml
    stt[steps:] = np.stack([s_ll, s_of, s_ml])
    dev = r_llc.device
    back = lambda x: torch.from_numpy(x.transpose(2, 0, 1).copy()).to(dev)
    fin = torch.from_numpy(np.stack([s_ll, s_of, s_ml])).to(dev)
    return back(sb), back(sn), back(stt), fin


def fse_encode_sequences(ll: torch.Tensor, ml: torch.Tensor,
                         offv: torch.Tensor, n_seq: torch.Tensor,
                         out_bytes: int, smax: int | None = None,
                         anchor_interval: int = 0,
                         return_words: bool = False):
    """Encode sequences (B, NSEQ) with the predefined FSE tables, in
    libzstd's emission order: the last sequence's extra bits (LL, ML,
    OF), then for each earlier sequence its state bits (OF, ML, LL) and
    extra bits (LL, ML, OF), then the state flushes (ML, OF, LL) and the
    sentinel.  smax bounds the steps.  Returns (stream (B, out_bytes)
    uint8, or int32 words with return_words, byte sizes (B,) int32); with
    anchor_interval A > 0 also (anchor bits (B, MAXA), anchor states (B,
    MAXA, 3) in LL, OF, ML order, anchor rep1 (B, MAXA)), int32, the
    decoder's position before sequence k * A (-1 / rep1 1 where
    absent)."""
    B, NSEQ = ll.shape
    S = NSEQ if smax is None else min(smax, NSEQ)
    dev = ll.device
    i64 = torch.int64
    ll, ml, offv = ll.to(i64), ml.to(i64), offv.to(i64)
    n = n_seq.to(i64)
    llc = ll_code_dev(ll).to(i64)
    mlc = torch.where(ml >= 3, ml_code_dev(torch.clamp(ml, min=3)).to(i64),
                      torch.zeros_like(ml))
    ofc = torch.where(offv > 0, exp_of(torch.clamp(offv, min=1)),
                      torch.zeros_like(offv))
    ll_bits, ll_base = _const(zf.LL_BITS, dev), _const(zf.LL_BASELINE, dev)
    ml_bits, ml_base = _const(zf.ML_BITS, dev), _const(zf.ML_BASELINE, dev)

    # encode order: step t codes sequence n_seq - 1 - t
    steps = torch.arange(S, device=dev)[None, :]
    rev_idx = torch.clamp(n[:, None] - 1 - steps, 0, NSEQ - 1)
    rev = lambda a: a.gather(1, rev_idx)
    r_llc, r_mlc, r_ofc = rev(llc), rev(mlc), rev(ofc)
    r_ll, r_ml, r_offv = rev(ll), rev(ml), rev(offv)
    active = steps < n[:, None]
    later = active & (steps > 0)
    zero = torch.zeros_like(r_ll)
    llc_c, mlc_c = torch.clamp(r_llc, 0, 35), torch.clamp(r_mlc, 0, 52)
    llb = torch.where(active, ll_bits[llc_c], zero)
    llv = r_ll - ll_base[llc_c]
    mlb = torch.where(active, ml_bits[mlc_c], zero)
    mlv = r_ml - ml_base[mlc_c]
    ofb = torch.where(active, r_ofc, zero)
    ofvx = r_offv - (1 << torch.clamp(r_ofc, min=0))
    sb, sn, st_steps, fin = _state_walk(r_llc, r_mlc, r_ofc,
                                        active & (steps == 0), later)
    # per step: OF, ML, LL state bits, then LL, ML, OF extra bits
    vals = torch.cat([sb, torch.stack([llv, mlv, ofvx], 2)], 2) \
        .reshape(B, S * 6)
    nbs = torch.cat([sn, torch.stack([llb, mlb, ofb], 2)], 2) \
        .reshape(B, S * 6)
    has = (n > 0).to(i64)
    s_ll, s_of, s_ml = fin
    flush_vals = torch.stack([
        s_ml & ((1 << zf.ML_DEFAULT_LOG) - 1),
        s_of & ((1 << zf.OF_DEFAULT_LOG) - 1),
        s_ll & ((1 << zf.LL_DEFAULT_LOG) - 1), torch.ones_like(has)], 1)
    flush_nbs = torch.stack([has * zf.ML_DEFAULT_LOG,
                             has * zf.OF_DEFAULT_LOG,
                             has * zf.LL_DEFAULT_LOG, has], 1)
    words, total_bits = BITS.pack_bits(torch.cat([vals, flush_vals], 1),
                                       torch.cat([nbs, flush_nbs], 1),
                                       out_bytes // 4)
    byte_sizes = (total_bits + 7) >> 3          # the sentinel is counted
    stream = words if return_words else BITS.words_to_bytes(words, out_bytes)
    if not anchor_interval:
        return stream, byte_sizes
    A = anchor_interval
    maxa = (S + A - 1) // A
    anchor_j = (torch.arange(1, maxa + 1, device=dev) * A)[None, :] \
        .expand(B, maxa)
    valid_a = anchor_j < n[:, None]
    ja = torch.clamp(anchor_j, max=NSEQ - 1)
    # extra bits the decoder reads for sequences before j
    dec_idx = torch.arange(NSEQ, device=dev)[None, :]
    dactive = dec_idx < n[:, None]
    ex_dec = torch.where(dactive, ll_bits[torch.clamp(llc, 0, 35)]
                         + ml_bits[torch.clamp(mlc, 0, 52)] + ofc,
                         torch.zeros_like(llc))
    ex_cum = torch.nn.functional.pad(torch.cumsum(ex_dec, 1), (1, 0))
    ex_before = C.take1(ex_cum, ja)
    # state bits read before sequence j: a suffix over encode steps
    # t >= n - j
    sn_cum = torch.cumsum(sn.sum(2), 1)
    t_at = torch.clamp(n[:, None] - 1 - anchor_j, 0, S - 1)
    st_before = sn_cum[:, -1:] - C.take1(sn_cum, t_at)
    init_reads = zf.LL_DEFAULT_LOG + zf.OF_DEFAULT_LOG + zf.ML_DEFAULT_LOG
    bits_a = (total_bits.to(i64) - 1)[:, None] - init_reads - ex_before \
        - st_before
    bits_a = torch.where(valid_a, bits_a, torch.full_like(bits_a, -1))
    # the decoder's states before sequence j are the encoder's after step
    # n - 1 - j, rebased from [tableSize, 2 tableSize) to table indices
    bias = (1 << zf.LL_DEFAULT_LOG, 1 << zf.OF_DEFAULT_LOG,
            1 << zf.ML_DEFAULT_LOG)
    states_a = torch.stack([C.take1(st_steps[:, :, k], t_at) - bias[k]
                            for k in range(3)], 2)
    # rep1 before sequence j: the last explicit offset among sequences < j
    push = dactive & (offv > 3)
    marked = torch.where(push, dec_idx.expand(B, NSEQ),
                         torch.full_like(offv, -1))
    lastpush = torch.cummax(marked, 1).values
    lastpush = torch.nn.functional.pad(lastpush[:, :-1], (1, 0), value=-1)
    lp = C.take1(lastpush, ja)
    rep1_a = torch.where(lp >= 0, C.take1(offv, torch.clamp(lp, min=0)) - 3,
                         torch.ones_like(lp))
    rep1_a = torch.where(valid_a, rep1_a, torch.ones_like(rep1_a))
    i32 = lambda t: t.to(torch.int32)
    return stream, byte_sizes, (i32(bits_a), i32(states_a), i32(rep1_a))
