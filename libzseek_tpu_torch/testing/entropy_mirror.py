"""Numpy mirrors of the CUDA phases of K2 (csrc/entropy.cu) and K3
(csrc/place_literals.cu) over their shared placement
(csrc/huf_place.cuh), for the tests: the chunk slots, each thread's
range of literals, the scans, which words a chunk stores and which it
leaves to the fix-up, and which words each sequence thread builds.
They assert what the kernels rely on (no word written twice, no bit
set by two codes, every sequence word built once), and their outputs
are held against ops/entropy.entropy_emit and
ops/vector_entropy.vector_literals.
"""

from __future__ import annotations

import numpy as np
import torch

from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops.entropy import (
    CTAB_OFF, CTAB_PREDEF, CTAB_WIDTH, LIT_ANCHOR_INTERVAL, MODE_HUF,
    MODE_HUF1, MODE_LL_RLE, MODE_LOG_SHIFT, MODE_ML_RLE, MODE_OF_RLE,
    MODE_RAWLIT, MODE_SEQ, SEQ_ANCHOR_INTERVAL, TAB_OFF, TABS, anchor_slots)

# csrc/huf_place.cuh's literal chunks: THREADS threads of PER literals
THREADS = 256
PER = 16
CHUNK = THREADS * PER


def huf_slots(N: int, four_only: bool) -> tuple[int, int, int]:
    """hp::slots: the literal chunk slots of an N-byte row (chunks of
    stream 0, which may hold every literal unless the kernel takes only
    4-stream rows; chunks of each of streams 1-3; slots in all)."""
    cps4 = -(-((N + 3) >> 2) // CHUNK)
    cps1 = cps4 if four_only else -(-N // CHUNK)
    return cps1, cps4, cps1 + 3 * cps4


def _lay(lc: int, one: bool):
    """(literals a stream, streams, each stream's count) as Lay gives them."""
    per = lc if one else (lc + 3) >> 2
    ns = 1 if one else 4
    cnt = [max(0, min(per, lc - k * per)) if k < ns else 0 for k in range(4)]
    return per, ns, cnt


def run_table(ll, ml, n: int):
    """tables_kernel's run table: cum[r] (literals before run r) and pos[r]
    (its first input byte), r = 0..n."""
    ll = np.asarray(ll[:n], np.int64)
    ml = np.asarray(ml[:n], np.int64)
    return (np.concatenate([[0], np.cumsum(ll)]),
            np.concatenate([[0], np.cumsum(ll + ml)]))


def run_source(cum, pos):
    """RunSrc: literal g's input byte, from the last run starting at or
    before g."""
    def src(g):
        r = np.searchsorted(cum, g, side="right") - 1
        return pos[r] + g - cum[r]
    return src


def chunk_sums_mirror(src, x, codes, lc: int, one: bool, N: int,
                      four_only: bool):
    """Phase 1: each visited chunk slot's code-length sum (slots the kernel
    does not visit stay 0 here; phase 2 never reads them)."""
    cps1, cps4, nch = huf_slots(N, four_only)
    per, ns, cnt = _lay(lc, one)
    cps = cps1 if one else cps4
    ln = np.asarray(codes, np.int64) & 15
    cbits = np.zeros(nch, np.int64)
    for s in range(ns):
        for c in range(cps):
            k = np.arange(c * CHUNK, min((c + 1) * CHUNK, cnt[s]))
            j = c if s == 0 else cps1 + (s - 1) * cps4 + c
            cbits[j] = ln[x[src(s * per + k)]].sum() if k.size else 0
    return cbits


def _or_codes(words: dict, vals, lens, poss) -> None:
    """OR codes (value < 2^length) in at their bit positions into a
    {word: value} dict, asserting that no two codes share a bit."""
    for v, n, p in zip(np.asarray(vals).tolist(), np.asarray(lens).tolist(),
                       np.asarray(poss).tolist()):
        big = v << (p & 31)
        for w, part in ((p >> 5, big & 0xFFFFFFFF), ((p >> 5) + 1, big >> 32)):
            if n and part:
                assert words.get(w, 0) & part == 0, ("overlapping bits", w)
                words[w] = words.get(w, 0) | part


class _WordOut:
    """WordOut: packs a stream from bit `start` and keeps the words
    [w0, w1), each whole."""

    def __init__(self, start: int, w0: int, w1: int):
        self.w, self.n, self.acc, self.w0, self.w1 = start >> 5, start & 31, \
            0, w0, w1
        self.words = {}

    def done(self) -> bool:
        return self.w >= self.w1

    def _emit(self):
        if self.w0 <= self.w < self.w1:
            self.words[self.w] = self.acc & 0xFFFFFFFF
        self.w += 1

    def put(self, v: int, nbits: int):
        self.acc |= v << self.n
        self.n += nbits
        if self.n >= 32:
            self._emit()
            self.acc >>= 32
            self.n -= 32

    def close(self):
        if self.n > 0:
            self._emit()


def place_literals_mirror(src, x, codes, lc: int, one: bool, N: int,
                          n_words: int, LMAXA: int, four_only: bool):
    """Phase 2 over every chunk of the row, after phase 1, and the fix-up:
    (words (n_words,) uint32 values, the 4 stream sizes, lanch (4,
    LMAXA)).  A chunk stores the words wholly inside its bit range (chunk
    0's with the stream's sentinel) and hands its edge words to the fix-up;
    asserts that no word is stored twice or both stored and handed on."""
    cps1, cps4, nch = huf_slots(N, four_only)
    per, ns, cnt = _lay(lc, one)
    cps = cps1 if one else cps4
    cbits = chunk_sums_mirror(src, x, codes, lc, one, N, four_only)
    slot = lambda s, c: c if s == 0 else cps1 + (s - 1) * cps4 + c
    bps = [sum(int(cbits[slot(s, c)]) for c in range(cps)) if s < ns else 0
           for s in range(4)]
    sz = [(bps[s] + 8) >> 3 if s < ns else 0 for s in range(4)]
    base = np.concatenate([[0], np.cumsum(sz)]).tolist()
    codes = np.asarray(codes, np.int64)
    lanch = np.full((4, LMAXA), -1, np.int64)
    stored, parts = {}, []
    for s in range(ns):
        for c in range(cps):
            if c > 0 and c * CHUNK >= cnt[s]:
                continue
            later = sum(int(cbits[slot(s, cc)]) for cc in range(c + 1, cps))
            k = np.arange(c * CHUNK, min((c + 1) * CHUNK, cnt[s]))
            p = codes[x[src(s * per + k)]] if k.size else \
                np.zeros(0, np.int64)
            ln = p & 15
            tid = (k - c * CHUNK) // PER
            tsum = np.bincount(tid, ln, minlength=THREADS).astype(np.int64)
            incl = np.cumsum(tsum)
            after = later + int(incl[-1]) - incl
            for t in range(THREADS):
                k0 = c * CHUNK + t * PER
                if 0 < k0 < cnt[s] and k0 % LIT_ANCHOR_INTERVAL == 0 and \
                        k0 // LIT_ANCHOR_INTERVAL - 1 < LMAXA:
                    lanch[s, k0 // LIT_ANCHOR_INTERVAL - 1] = \
                        after[t] + tsum[t]
            # a literal's bit: the stream's later threads, then the
            # thread's literals after it (incl[t] ends thread t's range)
            poss = 8 * base[s] + after[tid] + incl[tid] - np.cumsum(ln)
            win = {}
            _or_codes(win, p >> 4, ln, poss)
            lo = 8 * base[s] + later
            hi = lo + int(incl[-1]) + (c == 0)
            if c == 0:
                _or_codes(win, [1], [1], [hi - 1])
            if hi <= lo:
                continue
            wl, wh = lo >> 5, (hi - 1) >> 5
            whole = lambda w: w * 32 >= lo and (w + 1) * 32 <= hi
            for w in range(wl, wh + 1):
                if whole(w):
                    assert w not in stored, ("stored twice", w)
                    stored[w] = win.get(w, 0)
            if not whole(wl):
                parts.append((wl, win.get(wl, 0)))
            if wh != wl and not whole(wh):
                parts.append((wh, win.get(wh, 0)))
    out = np.zeros(n_words, np.int64)
    for w, v in stored.items():
        out[w] = v
    fixed: dict = {}
    for w, v in parts:
        assert w not in stored, ("stored and handed on", w)
        assert fixed.get(w, 0) & v == 0, ("overlapping bits", w)
        fixed[w] = fixed.get(w, 0) | v
    for w, v in fixed.items():
        out[w] = v
    return out, sz, lanch


def seq_mirror(ll, ml, of, n: int, mode: int, ct, SEQW: int, SMAXA: int):
    """A row's sequence block: every sequence's codes, the three state
    chains (of, ml, ll) recording each step's (nb, bv), each sequence's
    first bit from a scan of the widths, then each thread's whole words
    packed from the sequence holding the first one (asserting that every
    word is built once), the flushes and the sentinel, rep1 from the
    threads' last explicit offsets.  (words (SEQW,), bytes, sanch (5,
    SMAXA))."""
    sanch = np.full((5, SMAXA), -1, np.int64)
    if not (mode & MODE_SEQ) or n == 0:
        return np.zeros(SEQW, np.int64), 0, sanch
    T = TABS.astype(np.int64)
    ct = np.asarray(ct, np.int64)
    ll = np.asarray(ll[:n], np.int64)
    ml = np.asarray(ml[:n], np.int64)
    of = np.asarray(of[:n], np.int64)
    e = lambda v: np.floor(np.log2(np.maximum(v, 1))).astype(np.int64)
    mb = ml - 3
    llc = np.where(ll > 63, e(ll) + 19, T[TAB_OFF["ll_code"] +
                                         np.minimum(ll, 63)])
    mlc = np.where(mb > 127, e(mb) + 36,
                   T[TAB_OFF["ml_code"] + np.clip(mb, 0, 127)])
    ofc = e(of)
    code = {"of": ofc, "ml": mlc, "ll": llc}
    rec, fin = {}, {}
    tl = {}
    for k, dflt, rle_bit, row in (("of", zf.OF_DEFAULT_LOG, MODE_OF_RLE, 2),
                                  ("ml", zf.ML_DEFAULT_LOG, MODE_ML_RLE, 3),
                                  ("ll", zf.LL_DEFAULT_LOG, MODE_LL_RLE, 1)):
        tl[k] = ((mode >> MODE_LOG_SHIFT[k]) & 15) or dflt
        st, dn, df = (CTAB_OFF[f"{k}_{p}"] for p in ("st", "dnb", "dfs"))
        nb = np.zeros(n, np.int64)
        bv = np.zeros(n, np.int64)
        c = int(code[k][n - 1])
        d = int(ct[dn + c])
        b0 = (d + (1 << 15)) >> 16
        s = int(ct[st + (((b0 << 16) - d) >> b0) + int(ct[df + c])])
        for t in range(n):
            i = n - 1 - t
            if t:
                c = int(code[k][i])
                b = (s + int(ct[dn + c])) >> 16
                if not mode & rle_bit:
                    nb[t], bv[t] = b, s & ((1 << b) - 1)
                s = int(ct[st + (s >> b) + int(ct[df + c])])
            if i > 0 and i % SEQ_ANCHOR_INTERVAL == 0:
                sanch[row, i // SEQ_ANCHOR_INTERVAL - 1] = s - (1 << tl[k])
        rec[k], fin[k] = (nb, bv), s
    i = n - 1 - np.arange(n)          # the sequence emitted t-th
    llb = T[TAB_OFF["ll_bits"] + llc[i]]
    mlb = T[TAB_OFF["ml_bits"] + mlc[i]]
    (nof, bof), (nml, bml), (nll, bll) = rec["of"], rec["ml"], rec["ll"]
    vals = np.stack([bof | (bml << nof),
                     bll | ((ll[i] - T[TAB_OFF["ll_base"] + llc[i]]) << nll),
                     ml[i] - T[TAB_OFF["ml_base"] + mlc[i]],
                     of[i] - (1 << ofc[i])], 1)
    lens = np.stack([nof + nml, nll + llb, mlb, ofc[i]], 1)
    width = lens.sum(1)
    per = -(-n // THREADS)
    sb = np.concatenate([[0], np.cumsum(width)])   # each sequence's first bit
    total = int(sb[n])
    for t in range(n):
        ii = n - 1 - t
        if ii > 0 and ii % SEQ_ANCHOR_INTERVAL == 0:
            sanch[0, ii // SEQ_ANCHOR_INTERVAL - 1] = sb[t + 1]
    fl = []
    for k, bit in (("ml", MODE_ML_RLE), ("of", MODE_OF_RLE),
                   ("ll", MODE_LL_RLE)):
        fl.append((0, 0) if mode & bit else
                  (fin[k] & ((1 << tl[k]) - 1), int(tl[k])))
    fl.append((1, 1))
    end = total + sum(m for _, m in fl)
    # a thread builds whole words [w0, w1): from the sequence holding bit
    # 32 * w0 on, through the flushes if they reach its words
    nwd = -(-end // 32)
    pw = -(-nwd // THREADS)
    words = np.zeros(SEQW, np.int64)
    made = set()
    for u in range(THREADS):
        w0, w1 = min(nwd, u * pw), min(nwd, u * pw + pw)
        if w0 >= w1:
            continue
        t = int(np.searchsorted(sb, 32 * w0, side="right")) - 1
        o = _WordOut(int(sb[t]), w0, w1)
        while t < n and not o.done():
            for v_, n_ in zip(vals[t].tolist(), lens[t].tolist()):
                o.put(v_, n_)
            t += 1
        if not o.done():
            for v_, n_ in fl:
                o.put(v_, n_)
            o.close()
        assert not made & o.words.keys(), "a word built twice"
        made |= o.words.keys()
        for w, v in o.words.items():
            words[w] = v
    assert made == set(range(nwd)), "a word not built"
    # rep1: the threads' last explicit offsets, an exclusive max-scan
    last = [max([j for j in range(min(n, t * per), min(n, (t + 1) * per))
                 if of[j] > 3], default=-1) for t in range(THREADS)]
    for t in range(THREADS):
        prev = max(last[:t], default=-1)
        r1 = int(of[prev]) - 3 if prev >= 0 else 1
        for j in range(min(n, t * per), min(n, (t + 1) * per)):
            if j > 0 and j % SEQ_ANCHOR_INTERVAL == 0:
                sanch[4, j // SEQ_ANCHOR_INTERVAL - 1] = r1
            if of[j] > 3:
                r1 = int(of[j]) - 3
    return words, (end + 7) >> 3, sanch


def emit_mirror(x, sll, sml, soff, meta, codes, S: int, lit_cap: int,
                seq_cap: int, ctabs=None):
    """entropy_emit's outputs computed by the CUDA kernel's phases in
    numpy, row by row."""
    x, sll, sml, soff, meta, codes = (np.asarray(t) for t in (
        x, sll, sml, soff, meta, codes))
    B, N = x.shape
    LITW, SEQW = lit_cap // 4, seq_cap // 4
    LMAXA, SMAXA = anchor_slots(N, S)
    ct = np.broadcast_to(CTAB_PREDEF, (B, CTAB_WIDTH)) if ctabs is None \
        else np.asarray(ctabs)
    lit_w = np.zeros((B, LITW), np.int64)
    seq_w = np.zeros((B, SEQW), np.int64)
    osz = np.zeros((B, 8), np.int64)
    lanch = np.full((B, 4, LMAXA), -1, np.int64)
    sanch = np.full((B, 5, SMAXA), -1, np.int64)
    for b in range(B):
        _, lc, n, mode = (int(v) for v in meta[b, :4])
        cum, pos = run_table(sll[b], sml[b], n)
        src = run_source(cum, pos)
        if mode & MODE_RAWLIT:
            raw = np.zeros(4 * LITW, np.uint8)
            raw[:lc] = x[b][src(np.arange(lc))]
            lit_w[b] = raw.view("<u4")
            osz[b, 0] = lc
        elif mode & MODE_HUF:
            lit_w[b], osz[b, :4], lanch[b] = place_literals_mirror(
                src, x[b], codes[b], lc, bool(mode & MODE_HUF1), N, LITW,
                LMAXA, four_only=False)
        seq_w[b], osz[b, 4], sanch[b] = seq_mirror(
            sll[b], sml[b], soff[b], n, mode, ct[b], SEQW, SMAXA)
    i32 = lambda a: C.u32_to_i32(torch.from_numpy(a))
    return (i32(lit_w), i32(seq_w), i32(osz), i32(lanch), i32(sanch))


def mask_source(mask_words, length: int, on: bool):
    """MaskSrc of one row: (src, lc).  The mask words cut to the row's
    length (zero when the row is not taken), each word's rank (the
    literals before it), and src(g): the word of the last rank <= g, then
    its (g - rank)-th set bit."""
    w = np.asarray(mask_words).astype(np.uint32).astype(np.int64)
    nw = len(w)
    lo = np.arange(nw) * 32
    cut = np.where(lo >= length, 0, np.where(
        lo + 32 <= length, w, w & ((1 << np.clip(length - lo, 0, 31)) - 1)))
    eff = cut if on else np.zeros_like(cut)
    pop = np.array([bin(int(v)).count("1") for v in eff], np.int64)
    rank = np.cumsum(pop) - pop

    def src(g):
        g = np.asarray(g, np.int64)
        wi = np.searchsorted(rank, g, side="right") - 1
        bits = eff[wi].copy()
        k = g - rank[wi]
        for _ in range(31):
            m = k > 0
            bits[m] &= bits[m] - 1
            k[m] -= 1
        low = bits & -bits
        return wi * 32 + np.log2(np.maximum(low, 1)).astype(np.int64)
    return src, int(pop.sum())


def vector_mirror(x, lit_mask_words, codes_packed, lens, vec_row,
                  lit_cap: int):
    """vector_literals' outputs computed by the CUDA phases in numpy."""
    x, mask, codes, lens, vec = (np.asarray(t) for t in (
        x, lit_mask_words, codes_packed, lens, vec_row))
    B, N = x.shape
    LMAXA, _ = anchor_slots(N, 1)
    words = np.zeros((B, lit_cap // 4), np.int64)
    sizes = np.zeros((B, 4), np.int64)
    lanch = np.zeros((B, 4, LMAXA), np.int64)
    for b in range(B):
        src, lc = mask_source(mask[b], int(lens[b]), bool(vec[b]))
        words[b], sizes[b], lanch[b] = place_literals_mirror(
            src, x[b], codes[b], lc, False, N, lit_cap // 4, LMAXA,
            four_only=True)
    i32 = lambda a: C.u32_to_i32(torch.from_numpy(a))
    return i32(words), i32(sizes), i32(lanch)
