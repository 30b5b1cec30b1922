"""zstd block encoder: the stages around K1 (the linked parse) and K7
(the per-block hash parse).

Counterparts in libzseek_tpu/ops/zstd_encode.py: GATE_FIXED_BITS (:39),
SORT_GATE_BITS (:41), _const_byte (:79), zstd_sequences (:90, the sort
parser's, over ops/match.py), _fast_post (:416),
_fast_post_nolit (:473), extract_literals (:525), compact_payload (:544),
_hist_quarters (:596), _rep1_rewrite (:612), block_entropy_h16 (:668),
_linked_post (:695), level_search_params (:740), apply_ldm_override
(:768), ldm_literal_stats (:833), zstd_sequences_linked (:862),
zstd_sequences_fast (:895) and zstd_sequences_fast_nolit (:905).  The
`ZN_*` environment knobs of the reference are not ported; their defaults
are constants here.

Both float entropies are taken on the host from a device histogram, so
the card and the CPU agree: h16 is rounded to 1/16 bit, but the hash and
sort parsers' gate compares ml * H with an integer cost unrounded, where
one ulp of H flips a sequence, so gate_entropy reproduces the
reference's XLA arithmetic bit for bit (native zn_gate_entropy).
"""

from __future__ import annotations

import numpy as np
import torch

from libzseek_tpu_torch import native
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops.common import u32_to_i32
from libzseek_tpu_torch.ops.entropy import exp_of
from libzseek_tpu_torch.ops import match as M
from libzseek_tpu_torch.ops.hash_parse import hash_parse
from libzseek_tpu_torch.ops.parse_linked import parse_linked
from libzseek_tpu_torch.utils import trace

# fixed per-sequence bit cost the in-kernel profitability gate charges
GATE_FIXED_BITS = 14
# the sort and hash parsers' gate: fixed bits per sequence on top of the
# offset's
SORT_GATE_BITS = 20.0
# the gate's cost scale samples this many leading bytes of each block
H16_SAMPLE = 32768


def _const_byte(x, lengths, in_range):
    """Byte value of rows whose in-range bytes all equal the first, else
    -1 (zstd RLE block candidates)."""
    nonconst = ((x != x[:, :1]) & in_range).sum(1)
    return torch.where((nonconst == 0) & (lengths > 0),
                       x[:, 0].to(torch.int32),
                       torch.full_like(lengths, -1))


def zstd_sequences(x: torch.Tensor, lengths: torch.Tensor, *,
                   seg_size: int = 4, max_len: int = 16, max_back: int = 0,
                   max_offset: int = (1 << 17) - 1, dual: bool = False,
                   window: int = 8):
    """The sort parser's LZ77 parse of zstd blocks (ops/match.py, zstd's
    end rules), the profitability gate, greedy selection and run merging.
    A candidate stays when mlen * H > SORT_GATE_BITS + floor(log2(off +
    3)), H the row's byte entropy (gate_entropy).  Returns the dict of
    (B, N / seg_size + 1) ll, ml, offv (offset + 3, repcodes rewritten),
    and n_seq, last_literals, the compacted literal plane, lit_count,
    hist, hist_q and const."""
    B, N = x.shape
    dev = x.device
    nseq = N // seg_size + 1
    p, off, e, has = M.find_segment_matches(
        x, lengths, seg_size=seg_size, max_len=max_len, min_tail=4,
        max_back=max_back, end_margin=0, max_offset=max_offset, dual=dual,
        window=window)
    in_range = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    H = gate_entropy(C.hist256(x, in_range))
    cost = SORT_GATE_BITS + exp_of(torch.clamp(off + 3, min=1)) \
        .to(torch.float32)
    has = has & ((e - p).to(torch.float32) * H[:, None] > cost)
    sel, start, end, off, lit_from, c_final = M.greedy_select(
        p, off, e, has, lengths, min_tail=4)
    is_head, merged_end = M.merge_runs(sel, start, end, off, lit_from)
    rank = torch.cumsum(is_head, 1, dtype=torch.int32) - 1
    n_seq = is_head.sum(1, dtype=torch.int32)
    zero = torch.zeros((B, nseq), dtype=torch.int32, device=dev)
    seq_lit_from, seq_start, seq_end, seq_off = (
        C.scatter1_set(zero, rank, v, is_head)
        for v in (lit_from, start, merged_end, off))
    valid = torch.arange(nseq, device=dev)[None, :] < n_seq[:, None]
    ll = torch.where(valid, seq_start - seq_lit_from, zero)
    ml = torch.where(valid, seq_end - seq_start, zero)
    offv = _rep1_rewrite(torch.where(valid, seq_off + 3, zero), ll, valid)
    # literals: the bytes no selected match covers
    is_lit = ~C.fill_regions(N, seq_start, seq_end, valid) & in_range
    lit_count = is_lit.sum(1, dtype=torch.int32)
    hist_q = _hist_quarters(x, is_lit, lit_count)
    return dict(ll=ll, ml=ml, offv=offv, n_seq=n_seq,
                last_literals=lengths - c_final,
                literals=_literal_plane(x, is_lit), lit_count=lit_count,
                hist=hist_q.sum(1, dtype=torch.int32), hist_q=hist_q,
                const=_const_byte(x, lengths, in_range))


def _hist_quarters(x, is_lit, lit_count):
    """(B, 4, 256) literal histograms per Huffman stream: literal i (in
    literal order) belongs to stream min(i // ceil(lc/4), 3)."""
    B = x.shape[0]
    lit_rank = C.exclusive_cumsum(is_lit.to(torch.int32), dim=1)
    s = torch.clamp((lit_count + 3) >> 2, min=1)
    sid = torch.clamp(lit_rank // s[:, None], max=3)
    v = (sid << 8) | x.to(torch.int32)
    return C.hist_nk(v, is_lit, 1024).reshape(B, 4, 256)


def _rep1_rewrite(offv, ll, valid):
    """Code repeated distances as repcodes 1/2/3 by simulating the
    decoder's repeat-offset state per row.  Slots start at an impossible
    sentinel so a slot is eligible only once written in-block; ll == 0
    sequences and each block's first sequence stay explicit.

    The reference scans all 8192 slots; slots past a row's n_seq never
    change, so the walk stops at the batch's largest n_seq.  The walk is
    sequential over sequences and vectorised over rows; it runs on the
    host, where a step costs a microsecond instead of a kernel launch."""
    dev = offv.device
    ov_all = offv.cpu().numpy()
    nmax = int(valid.sum(1).max()) if valid.numel() else 0
    if nmax == 0:
        return offv
    ovT = np.ascontiguousarray(ov_all[:, :nmax].T)
    llT = np.ascontiguousarray(ll.cpu().numpy()[:, :nmax].T)
    okT = np.ascontiguousarray(valid.cpu().numpy()[:, :nmax].T)
    B = ov_all.shape[0]
    r1 = np.full(B, -(1 << 30), np.int32)
    r2 = r1.copy()
    r3 = r1.copy()
    outT = ovT.copy()
    for t in range(nmax):
        ov = ovT[t]
        dist = ov - 3
        eok = okT[t] & (ov > 3)
        elp = eok & (llT[t] > 0)
        hit1 = elp & (dist == r1)
        hit2 = elp & (dist == r2) & ~hit1
        hit3 = elp & (dist == r3) & ~hit1 & ~hit2
        outT[t] = np.where(hit1, 1, np.where(hit2, 2, np.where(hit3, 3, ov)))
        n3 = np.where(hit3 | (eok & ~hit1 & ~hit2), r2, r3)
        n2 = np.where(eok & ~hit1, r1, r2)
        r1 = np.where(eok, dist, r1)
        r2, r3 = n2, n3
    out = ov_all.copy()
    out[:, :nmax] = outT.T
    return torch.from_numpy(out).to(dev)


def block_entropy_h16(x: torch.Tensor, lengths: torch.Tensor):
    """Per-row byte entropy of the first 32 KiB in 1/16 bits, clipped to
    [1, 8] bits: the gate's cost scale.  Returns (h16, hist).

    The float32 entropy is computed on the host from the histogram, so a
    row gets the same h16 whichever device holds the bytes."""
    B, N = x.shape
    NS = min(N, H16_SAMPLE)
    xs = x[:, :NS]
    pos = torch.arange(NS, device=x.device)
    in_range = pos[None, :] < torch.clamp(lengths, max=NS)[:, None]
    hist = C.hist256(xs, in_range)
    h = hist.cpu()
    pr = h.to(torch.float32) / torch.clamp(
        h.sum(1, keepdim=True).to(torch.float32), min=1.0)
    H = -torch.where(pr > 0, pr * torch.log2(torch.clamp(pr, min=1e-9)),
                     torch.zeros_like(pr)).sum(1)
    h16 = torch.round(torch.clamp(H, 1.0, 8.0) * 16.0).to(torch.int32)
    return h16.to(x.device), hist


def _linked_post(x, lengths, ll, ml, offv, n_seq, cover, cap: int,
                 lit_mask):
    """Literal statistics after the gated parse: coverage from the
    parse's literal bitmask (bit i of word w = byte 32w+i, 1 = literal),
    per-stream literal histograms, RLE-block detection, repcodes."""
    B, N = x.shape
    dev = x.device
    idx = torch.arange(cap, device=dev)
    valid = idx[None, :] < n_seq[:, None]
    in_range = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    bits = (lit_mask[:, :, None] >> shifts[None, None, :]) & 1
    is_lit = (bits != 0).reshape(B, N) & in_range
    zero = torch.zeros_like(ll)
    ml_v = torch.where(valid, ml, zero)
    ll_v = torch.where(valid, ll, zero)
    lit_count = (lengths - ml_v.sum(1)).to(torch.int32)
    hist_q = _hist_quarters(x, is_lit, lit_count)
    return dict(ll=ll_v, ml=ml_v, hist_q=hist_q,
                offv=_rep1_rewrite(torch.where(valid, offv, zero), ll_v,
                                   valid),
                n_seq=n_seq, last_literals=(lengths - cover),
                lit_count=lit_count, hist=hist_q.sum(1).to(torch.int32),
                const=_const_byte(x, lengths, in_range), lit_mask=lit_mask)


def gate_entropy(hist: torch.Tensor) -> torch.Tensor:
    """(B, 256) byte histograms -> (B,) float32 byte entropy in bits,
    clipped to [1, 8], on the histogram's device: the hash gate's cost
    scale, computed on the host as the reference's XLA code does."""
    h = native.gate_entropy(hist.cpu().numpy())
    return torch.from_numpy(h).to(hist.device)


def _fast_post(x, lengths, ll, ml, offv, n_seq, cover, cap: int,
               plane: bool = True):
    """The hash parse's profitability gate and recompaction after K7: a
    sequence stays when ml * H > SORT_GATE_BITS + floor(log2(offv)), and
    the literal runs around dropped ones re-join; then the literal
    statistics and, with `plane`, the compacted literal plane (the XLA
    entropy arm's input)."""
    B, N = x.shape
    dev = x.device
    seq_end = torch.cumsum(ll + ml, 1, dtype=torch.int32)
    seq_start = seq_end - ml
    idx = torch.arange(cap, device=dev)[None, :]
    valid = idx < n_seq[:, None]
    in_range = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    H = gate_entropy(C.hist256(x, in_range))
    cost = SORT_GATE_BITS + exp_of(torch.clamp(offv, min=1)) \
        .to(torch.float32)
    keep = valid & (ml.to(torch.float32) * H[:, None] > cost)
    rank = torch.cumsum(keep, 1, dtype=torch.int32) - 1
    n2 = keep.sum(1, dtype=torch.int32)
    zero = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    start_k, end_k, off_k = (C.scatter1_set(zero, rank, v, keep)
                             for v in (seq_start, seq_end, offv))
    valid2 = idx < n2[:, None]
    prev_end = torch.nn.functional.pad(end_k[:, :-1], (1, 0))
    ll2 = torch.where(valid2, start_k - prev_end, zero)
    ml2 = torch.where(valid2, end_k - start_k, zero)
    off2 = _rep1_rewrite(torch.where(valid2, off_k, zero), ll2, valid2)
    cover2 = torch.where(valid2, end_k, zero).max(1).values
    is_lit = ~C.fill_regions(N, start_k, end_k, valid2) & in_range
    lit_count = is_lit.sum(1, dtype=torch.int32)
    hist_q = _hist_quarters(x, is_lit, lit_count)
    out = dict(ll=ll2, ml=ml2, offv=off2, n_seq=n2,
               last_literals=lengths - cover2, lit_count=lit_count,
               hist=hist_q.sum(1, dtype=torch.int32), hist_q=hist_q,
               const=_const_byte(x, lengths, in_range))
    if plane:
        out["literals"] = _literal_plane(x, is_lit)
    return out


def _fast_post_nolit(x, lengths, ll, ml, offv, n_seq, cover, cap: int):
    """_fast_post without the literal plane (K2 reads literals from the
    raw rows)."""
    return _fast_post(x, lengths, ll, ml, offv, n_seq, cover, cap,
                      plane=False)


def _literal_plane(x, is_lit):
    """(B, N) uint8: each row's literal bytes compacted to its front."""
    rank = C.exclusive_cumsum(is_lit.to(torch.int32), dim=1)
    return C.scatter1_set(torch.zeros_like(x), rank, x, is_lit)


def extract_literals(x, lengths, ll, ml, n_seq):
    """The compacted literal plane of final sequences (B, N) uint8: the
    XLA entropy arm's input when the parse did not make one."""
    B, N = x.shape
    cap = ll.shape[1]
    dev = x.device
    seq_end = torch.cumsum(ll + ml, 1, dtype=torch.int32)
    valid = torch.arange(cap, device=dev)[None, :] < n_seq[:, None]
    in_match = C.fill_regions(N, seq_end - ml, seq_end, valid)
    is_lit = ~in_match & (torch.arange(N, device=dev)[None, :]
                          < lengths[:, None])
    return _literal_plane(x, is_lit)


def zstd_sequences_fast(x: torch.Tensor, lengths: torch.Tensor):
    """K7 plus the gate, with the literal plane (the XLA entropy arm)."""
    with trace.span("zseek.parse"):
        ll, ml, offv, n_seq, cover = hash_parse(x, lengths)
    with trace.span("zseek.fast_post"):
        return _fast_post(x, lengths, ll, ml, offv, n_seq, cover,
                          ll.shape[1])


def zstd_sequences_fast_nolit(x: torch.Tensor, lengths: torch.Tensor):
    """K7 plus the gate, without the literal plane (the K2 arm)."""
    with trace.span("zseek.parse"):
        ll, ml, offv, n_seq, cover = hash_parse(x, lengths)
    with trace.span("zseek.fast_post"):
        return _fast_post_nolit(x, lengths, ll, ml, offv, n_seq, cover,
                                ll.shape[1])


def level_search_params(level: int) -> dict:
    """zstd compression level -> linked-parse search effort, the
    reference's ladder: from level 4 up the dual table, lazy matching, the
    repcode probe and the cheaper gate (7 bits a sequence), with the miss
    accelerator slowed as the level rises."""
    if level <= 1:
        return dict(min_match=6, lazy=0, accel_log=5, dual=False)
    if level <= 3:
        return dict(min_match=5, lazy=0, accel_log=6, dual=False)
    high = dict(min_match=5, dual=True, rep_probe=True, gate_bits=7)
    if level <= 8:
        return dict(high, lazy=1, accel_log=8)
    if level <= 15:
        return dict(high, lazy=2, accel_log=10)
    return dict(high, lazy=2, accel_log=14)


def zstd_sequences_linked(x2: torch.Tensor, lengths: torch.Tensor,
                          min_abs: torch.Tensor, level: int = 3,
                          parse_lengths: torch.Tensor | None = None):
    """Linked-block gated parse (K1) plus its literal statistics.  x2 is
    the shifted block array (row r+1 = block r, row r its context);
    outputs align with x2[1:].  parse_lengths: zeroed rows skip the
    parse (LDM-covered blocks); statistics use the real lengths."""
    x = x2[1:]
    with trace.span("zseek.h16"):
        h16, _ = block_entropy_h16(x, lengths)
    pl = lengths if parse_lengths is None else parse_lengths
    with trace.span("zseek.parse"):
        ll, ml, offv, n_seq, cover, lmask = parse_linked(
            x2, pl, min_abs, h16,
            **{"gate_bits": GATE_FIXED_BITS, **level_search_params(level)})
    with trace.span("zseek.linked_post"):
        return _linked_post(x, lengths, ll, ml, offv, n_seq, cover,
                            ll.shape[1], lmask)


def apply_ldm_override(seqs: dict, spans: np.ndarray, lengths: np.ndarray,
                       lit_hist: np.ndarray,
                       lit_plane: np.ndarray | None = None) -> dict:
    """Replace covered blocks' parse output with the single long-match
    sequence of the LDM pre-pass (native zn_ldm_scan): spans (B, 3)
    [dist, s, e), lit_hist (B, 4, 256) per-stream literal histograms of
    the covered rows' remaining literals, lit_plane (B, N) their literal
    rows, for sequences that carry a literal plane.  Covered rows'
    literal bitmask, where there is one, is rebuilt from the span."""
    dev = seqs["ll"].device
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)
    cm = torch.from_numpy(spans[:, 0] > 0).to(dev)
    cap = seqs["ll"].shape[1]
    first = torch.zeros((1, cap), dtype=torch.bool, device=dev)
    first[0, 0] = True
    m = cm[:, None] & first
    dv, sv, ev = t(spans[:, 0]), t(spans[:, 1]), t(spans[:, 2])
    ln = t(lengths)
    zero = torch.zeros_like(seqs["ll"])
    out = dict(seqs)
    out["ll"] = torch.where(m, sv[:, None],
                            torch.where(cm[:, None], zero, seqs["ll"]))
    out["ml"] = torch.where(m, (ev - sv)[:, None],
                            torch.where(cm[:, None], zero, seqs["ml"]))
    out["offv"] = torch.where(m, (dv + 3)[:, None],
                              torch.where(cm[:, None], zero, seqs["offv"]))
    out["n_seq"] = torch.where(cm, torch.ones_like(dv), seqs["n_seq"])
    out["last_literals"] = torch.where(cm, ln - ev, seqs["last_literals"])
    out["lit_count"] = torch.where(cm, sv + (ln - ev), seqs["lit_count"])
    out["hist_q"] = torch.where(cm[:, None, None], t(lit_hist),
                                seqs["hist_q"])
    out["hist"] = out["hist_q"].sum(1).to(torch.int32)
    if lit_plane is not None and "literals" in seqs:
        out["literals"] = torch.where(
            cm[:, None], torch.from_numpy(lit_plane).to(dev),
            seqs["literals"])
    if "lit_mask" not in seqs:
        return out
    NW32 = seqs["lit_mask"].shape[1]
    w0 = torch.arange(NW32, device=dev, dtype=torch.int64)[None, :] * 32
    lo = torch.clamp(sv[:, None].long() - w0, 0, 32)
    hi = torch.clamp(ev[:, None].long() - w0, 0, 32)
    ones = 0xFFFFFFFF
    mlo = torch.where(lo < 32, (ones << lo) & ones, torch.zeros_like(lo))
    mhi = torch.where(hi < 32, (ones << hi) & ones, torch.zeros_like(hi))
    litw = u32_to_i32(~(mlo & ~mhi))
    out["lit_mask"] = torch.where(cm[:, None], litw, seqs["lit_mask"])
    return out


def ldm_literal_stats(spans: np.ndarray, blocks, Bp: int):
    """Host-side literal stats for LDM-covered blocks: (Bp, 3) padded
    spans and per-stream literal histograms (Bp, 4, 256) of the covered
    blocks' remaining literals [block[:s] || block[e:]]."""
    spans_p = np.zeros((Bp, 3), np.int64)
    spans_p[: len(spans)] = spans
    hist = np.zeros((Bp, 4, 256), np.int64)
    for i in range(len(spans)):
        d, s, e = spans[i]
        if d <= 0:
            continue
        blk = np.asarray(blocks[i])
        lits = np.concatenate([blk[:s], blk[e:]])
        if len(lits):
            q = (len(lits) + 3) >> 2
            for k in range(4):
                part = lits[k * q: len(lits) if k == 3 else (k + 1) * q]
                if len(part):
                    hist[i, k] = np.bincount(part, minlength=256)
    return spans_p, hist


def ldm_literal_plane(spans: np.ndarray, blocks, Bp: int, N: int):
    """(Bp, N) uint8 literal rows [block[:s] || block[e:]] of the
    LDM-covered blocks (zeros elsewhere), for sequences that carry a
    literal plane."""
    plane = np.zeros((Bp, N), np.uint8)
    for i in range(len(spans)):
        d, s, e = spans[i]
        if d > 0:
            blk = np.asarray(blocks[i])
            lits = np.concatenate([blk[:s], blk[e:]])
            plane[i, : len(lits)] = lits
    return plane


def compact_payload(lit_words: torch.Tensor, lit_bytes: torch.Tensor,
                    seq_words: torch.Tensor, seq_bytes: torch.Tensor,
                    cap_words: int):
    """Pack each row's live literal and sequence stream prefixes into one
    dense word buffer, in 32-word tiles.  lit_words (B, LW), seq_words
    (B, SW) int32 words; lit_bytes, seq_bytes (B,) used bytes.  Returns
    (flat (cap_words,), base_words (B,), lit_words_used (B,)): row r's
    literal stream occupies bytes [4*base[r], 4*base[r] + lit_bytes[r])
    and its sequence stream starts at byte 4*(base[r] + lw[r])."""
    B, LW = lit_words.shape
    SW = seq_words.shape[1]
    T = 32
    assert cap_words % T == 0, cap_words
    assert LW % T == 0, LW
    dev = lit_words.device
    lw = (((lit_bytes + 3) >> 2) + T - 1) & ~(T - 1)
    sw = (((seq_bytes + 3) >> 2) + T - 1) & ~(T - 1)
    row_words = lw + sw
    base = (torch.cumsum(row_words, 0) - row_words).to(torch.int32)
    src = torch.cat([lit_words, seq_words], dim=1)
    LT = LW + SW
    pad = (-LT) % T
    if pad:
        src = torch.nn.functional.pad(src, (0, pad))
        LT += pad
    src2 = src.reshape(B * (LT // T), T)
    nt = cap_words // T
    it = torch.arange(nt, dtype=torch.int32, device=dev) * T
    r = torch.clamp(torch.searchsorted(base, it, right=True) - 1, 0, B - 1)
    d = it - base[r]
    lwr = lw[r]
    ct = torch.where(d < lwr, d, LW + (d - lwr)) // T
    ct = torch.clamp(r * (LT // T) + ct, 0, B * (LT // T) - 1)
    live = d < row_words[r]
    flat2 = torch.where(live[:, None], src2[ct], torch.zeros_like(src2[:1]))
    return flat2.reshape(-1), base, lw.to(torch.int32)
