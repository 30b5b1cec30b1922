"""numpy mirror of csrc/plan.cu's phases, used only by tests.

The kernel runs a block a row.  All its threads count the row's LL, OF
and ML codes (seq_code_hists); then warp 0 builds the Huffman plan
(huffman_row) and warps 1-3 the three sequence tables (seq_table), each
warp's lanes holding consecutive symbols (8 a lane for the Huffman warp,
2 for a stream's).  The mirror keeps that layout: a warp's registers are
a (32, per-lane) array, a warp reduction is a reduction over it, and
"the first index" of a best value is the lowest lane whose own best (its
first in ascending order) equals the warp's, as the kernel's ballot
finds it.  The float32 arithmetic of the bisection is numpy float32 with
the same operations in the same order.

Its phases: the grow rounds' bisection; the single moves, stopped per
row when the budget is exact or no move applies; the balanced fallback
as a rank count over (count, index); the flat-code fix; the canonical
codes by a scan of the lanes' counts per code length, from the longest;
the mode decision; then per stream the normalisation at both logs, the
costs, the choice, and the state table built directly (slot k's symbol
by a search of the cumulative norms, spread to (k * step) & (tab - 1),
positions in rounds of 32, a position's rank among its symbol's lanes in
the round added to the symbol's running slot).  `stats` counts the rows
that took each branch, so a test can show its rows reach them.
"""

from __future__ import annotations

import numpy as np

from libzseek_tpu_torch.ops import huffman_plan as hp

MAX_BITS, TAB, KMAX, BIG = 11, 1 << 11, 1 << 10, 1 << 30
MOVES, ROUNDS, STEPS = 64, 8, 24
MIN_SEQ_FSE = 32
NEG = int(np.float32(-1e30).view(np.int32))
POS = int(np.float32(1e30).view(np.int32))
F32 = np.float32

# csrc/plan.cu's constant table (ops/huffman_plan.py plan_table)
T_LL_CODE, T_ML_CODE, T_PD16 = 0, 64, 192
T_COST = {5: 310, 6: 343, 8: 408, 9: 665}
T_PREDEF = 1178

# streams LL, OF, ML: (symbols, predefined log, largest log, log shift,
# RLE bit, FSE bit, offset of the norms and histograms); the pack's
# offsets are ops/huffman_plan.py KERNEL_LAYOUT's
STREAMS = (("ll", 36, 6, 9, 12, 16, 128, 0),
           ("of", 29, 5, 8, 16, 32, 256, 36),
           ("ml", 53, 6, 9, 20, 64, 512, 65))
CTAB_W = hp.KERNEL_LAYOUT["ctab_width"]
NORM_W = hp.KERNEL_LAYOUT["norm_width"]


def flog2(x):
    """floor(log2(max(x, 1))) of ints."""
    return np.frexp(np.maximum(np.asarray(x, np.int64), 1)
                    .astype(np.float64))[1] - 1


def first_of(vals: np.ndarray, is_max: bool) -> int:
    """The index the kernel's first_of returns for a (32, per-lane) array
    of the lanes' values."""
    w = vals.shape[1]
    local = vals.argmax(1) if is_max else vals.argmin(1)
    best = vals[np.arange(32), local]
    g = best.max() if is_max else best.min()
    lane = int(np.nonzero(best == g)[0][0])
    return lane * w + int(local[lane])


def seq_code_hists(ll, ml, offv, n_seq, S, tabs):
    """The row's LL, OF and ML code histograms (the kernel's first phase:
    every thread, shared-memory atomics)."""
    n = min(max(int(n_seq), 0), S)
    ll = ll[:n].astype(np.int64)
    ml = ml[:n].astype(np.int64)
    of = offv[:n].astype(np.int64)
    lc = np.where(ll > 63, flog2(ll) + 19, tabs[T_LL_CODE + np.clip(ll, 0, 63)])
    mb = np.maximum(ml, 3) - 3
    mc = np.where(ml >= 3, np.where(mb > 127, flog2(mb) + 36,
                                    tabs[T_ML_CODE + np.clip(mb, 0, 127)]), 0)
    oc = np.where(of > 0, flog2(of), 0)
    out = []
    for codes, (_, ns, *_r) in zip((lc, oc, mc), STREAMS):
        out.append(np.bincount(np.clip(codes, 0, ns - 1), minlength=ns))
    return out


def assign_kraft_row(h: np.ndarray, stats: dict) -> np.ndarray:
    """The Huffman warp's Kraft budgets, (32, 8) int64."""
    H = h.astype(np.int64).reshape(32, 8)
    m = int((H > 0).sum())
    total = int(H.sum())
    sc = np.maximum(H * TAB // max(total, 1), 1)
    k0 = np.clip(1 << np.clip(flog2(sc), 0, 10), 1, KMAX)
    k = np.where((H > 0) & (m >= 2), k0, 0)
    hf = H.astype(F32)

    for _ in range(ROUNDS):
        D = max(TAB - int(k.sum()), 0)
        el = (k > 0) & (k < KMAX)
        prio = np.where(el, hf / np.maximum(k, 1).astype(F32), F32(-1e30))
        cost = np.where(el, k, 0)
        hi = F32(np.where(el, prio, F32(0)).max()) + F32(1)
        lo = F32(0)
        for _ in range(STEPS):
            mid = F32(0.5) * (lo + hi)
            if int(np.where(prio >= mid, cost, 0).sum()) <= D:
                hi = mid
            else:
                lo = mid
        k = np.where(el & (prio >= hi), k * 2, k)

    moves = 0
    for _ in range(MOVES):
        K = int(k.sum())
        if K == TAB or int((k > 0).sum()) < 2:
            break
        D = TAB - K
        lim_g = 1 << int(np.clip(flog2(max(D, 1)), 0, 10))
        lim_s = 2 << int(np.clip(flog2(max(-D, 1)), 0, 10))
        pr = (hf / np.maximum(k, 1).astype(F32)).view(np.int32) \
            .astype(np.int64)
        eg = (k > 0) & (k <= lim_g) & (k < KMAX)
        es = (k >= 2) & (k <= lim_s)
        ep = (k > 0) & (k < KMAX)
        grow = D > 0
        can = eg.any() if grow else (es.any() or ep.any())
        if not can:
            stats["stuck"] = stats.get("stuck", 0) + 1
            break
        if grow:
            pick = first_of(np.where(eg, pr, NEG), True)
        elif es.any():
            pick = first_of(np.where(es, pr, POS), False)
            stats["shrink"] = stats.get("shrink", 0) + 1
        else:
            pick = first_of(np.where(ep, k, BIG), False)
            stats["least_k"] = stats.get("least_k", 0) + 1
        do_grow = grow or not es.any()
        k.flat[pick] = k.flat[pick] * 2 if do_grow else k.flat[pick] // 2
        moves += 1
    stats["most_moves"] = max(stats.get("most_moves", 0), moves)

    if int(k.sum()) != TAB and m >= 2:
        stats["fallback"] = stats.get("fallback", 0) + 1
        L = max(int(flog2(max(m - 1, 1))) + 1, 1)
        n_short = (1 << L) - m
        k_hi = 1 << int(np.clip(12 - L, 1, 11))
        k_lo = 1 << int(np.clip(11 - L, 0, 10))
        hv = H.reshape(-1)
        i = np.arange(256)
        before = (hv[None, :] > 0) & (
            (hv[None, :] > hv[:, None]) |
            ((hv[None, :] == hv[:, None]) & (i[None, :] < i[:, None])))
        rank = before.sum(1).reshape(32, 8)
        k = np.where(H > 0, np.where(rank < n_short, k_hi, k_lo), 0)

    used = k > 0
    kx = int(np.where(used, k, 0).max())
    kn = int(np.where(used, k, BIG).min())
    if m > 127 and kx == kn and kn >= 2 and kx < KMAX:
        stats["flat"] = stats.get("flat", 0) + 1
        idx = np.arange(256).reshape(32, 8)
        top = first_of(np.where(used, H, -1), True)
        b1 = first_of(np.where(used & (idx != top), H, BIG), False)
        b2 = first_of(np.where(used & (idx != top) & (idx != b1), H, BIG),
                      False)
        k.flat[top] *= 2
        k.flat[b1] //= 2
        k.flat[b2] //= 2
    return k


def huffman_row(h, hq, lc, blen, cnst, kw, stats):
    """Warp 0: (mode, mode_bits, codes_packed (256,), weights_packed (32,),
    rle_byte, sizes4 (4,)) of one row."""
    k = assign_kraft_row(h, stats)
    H = h.astype(np.int64).reshape(32, 8)
    length = np.where(k > 0, MAX_BITS - flog2(k), 0)
    max_bits = int(length.max())
    code = np.zeros_like(length)
    mn = 0
    for nb in range(MAX_BITS, 0, -1):
        is_nb = length == nb
        c = is_nb.sum(1)
        excl = np.cumsum(c) - c
        within = np.cumsum(is_nb, 1) - 1
        code = np.where(is_nb, mn + excl[:, None] + within, code)
        mn = (mn + int(c.sum())) >> 1
    codes = ((code << 4) | length).reshape(-1)
    w = np.where(k > 0, max_bits + 1 - length, 0)
    words = (w.astype(np.uint32) << (4 * np.arange(8, dtype=np.uint32))) \
        .sum(1, dtype=np.uint32).view(np.int32)

    m = int((H > 0).sum())
    rle_byte = first_of(H, True)
    last = int(np.nonzero(h > 0)[0].max()) if m else -1
    lens = length.reshape(-1)
    est_bits = int((h.astype(np.int64) * lens).sum())
    bq = (hq.astype(np.int64) * lens[None, :]).sum(1)
    tree_bound = 1 + (max(last, 0) + 1) // 2 if last <= 127 else 128
    one = lc < 256
    s4 = np.array([(est_bits + 8) >> 3, 0, 0, 0]) if one else (bq + 8) >> 3
    est_payload = int(s4.sum()) + tree_bound + (0 if one else 6)
    raw_hdr = 1 if lc < 32 else (2 if lc < 4096 else 3)
    huf_hdr = 3 if (lc <= 1023 and est_payload <= 1023) else \
        (4 if (lc <= 16383 and est_payload <= 16383) else 5)
    huf_ok = m >= 2 and lc >= 64 and est_payload < lc and \
        huf_hdr + est_payload < raw_hdr + lc
    md = (hp.M_HUF1 if one else hp.M_HUF) if huf_ok else hp.M_RAW
    if md == hp.M_RAW and lc > 0 and raw_hdr + lc + 1 >= blen:
        md = hp.M_SKIP
    if m == 1:
        md = hp.M_RLE
    if lc == 0:
        md = hp.M_NONE
    if cnst >= 0 and blen > 4:
        md = hp.M_RLEBLOCK
    mb = kw["mode_huf"] | kw["mode_seq"] if md == hp.M_HUF else 0
    if md == hp.M_HUF1:
        mb = kw["mode_huf"] | kw["mode_huf1"] | kw["mode_seq"]
    if md == hp.M_RAW and lc > 0:
        mb = kw["mode_rawlit"] | kw["mode_seq"]
    if md in (hp.M_NONE, hp.M_RLE) or (md == hp.M_RAW and lc == 0):
        mb = kw["mode_seq"]
    if md in (hp.M_SKIP, hp.M_RLEBLOCK):
        mb = 0
    if blen == 0:
        mb, md = 0, hp.M_SKIP
    if md not in (hp.M_HUF, hp.M_HUF1):
        s4 = np.zeros(4, np.int64)
    return md, mb, codes, words, rle_byte, s4


def _normalize(H, lg, total, top):
    tab = 1 << lg
    n = np.where(H > 0, np.maximum(H * tab // max(total, 1), 1), 0)
    fixed = int(n.flat[top]) + tab - int(n.sum())
    n.flat[top] = max(fixed, 1)
    return n, fixed >= 1 and int(n.sum()) == tab


def _cost(H, n, lg, last, tabs):
    cb = np.where(n > 0, tabs[T_COST[lg] + np.clip(n, 0, 1 << lg)], 0)
    return (int((H * cb).sum()) >> 4) + \
        ((4 + (last + 1) * (lg + 2) + 7) >> 3) * 8


def state_table(norm: np.ndarray, lg: int) -> np.ndarray:
    """FSE_buildCTable's state table, built directly: slot k's symbol by
    a search of the cumulative norms, spread to (k * step) & (tab - 1),
    then positions in rounds of 32 ascending; a position's entry is its
    symbol's running slot plus its rank among the round's lanes of that
    symbol (__match_any_sync)."""
    tab = 1 << lg
    step = (tab >> 1) + (tab >> 3) + 3
    cum_in = np.cumsum(norm)
    nxt = cum_in - norm
    spread = np.zeros(tab, np.int64)
    k = np.arange(tab)
    spread[(k * step) & (tab - 1)] = np.searchsorted(cum_in, k, side="right")
    st = np.zeros(tab, np.int64)
    for p0 in range(0, tab, 32):
        s = spread[p0: p0 + 32]
        same = s[None, :] == s[:, None]
        rank = np.tril(same, -1).sum(1)
        st[nxt[s] + rank] = tab + p0 + np.arange(32)
        np.add.at(nxt, s, 1)
    return st


def seq_table(hist_s, n_seq, stream, tabs, stats):
    """Warp 1 + stream: (flags, gain, st (2^largest log,), dnb, dfs,
    norms, rle symbol)."""
    key, ns, lg, lm, shift, rle_bit, fse_bit, no = stream
    H = np.zeros(64, np.int64)
    H[:ns] = hist_s
    H = H.reshape(32, 2)
    valid = (np.arange(64) < ns).reshape(32, 2)
    nz = int((H > 0).sum())
    total = int(H.sum())
    pd = np.zeros(64, np.int64)
    pd[:ns] = tabs[T_PD16 + no: T_PD16 + no + ns]
    bits_pd = int((H * pd.reshape(32, 2)).sum()) >> 4
    last = int(np.nonzero(H.reshape(-1) > 0)[0].max()) if nz else 0
    sym = first_of(np.where(valid, H, -1), True)
    nd, ok_d = _normalize(H, lg, total, sym)
    nm, ok_m = _normalize(H, lm, total, sym)
    cost_d = _cost(H, nd, lg, last, tabs)
    cost_m = _cost(H, nm, lm, last, tabs)
    base_ok = nz >= 2 and n_seq >= MIN_SEQ_FSE
    ok_d = ok_d and base_ok and cost_d + 16 < bits_pd
    ok_m = ok_m and base_ok and cost_m + 16 < bits_pd
    pick_m = ok_m and (not ok_d or cost_m < cost_d)
    rle = nz == 1 and n_seq > 0
    use_m = pick_m and not rle
    use_d = ok_d and not pick_m and not rle
    for name, hit in (("rle", rle), ("max_log", use_m), ("pre_log", use_d)):
        stats[name] = stats.get(name, 0) + int(hit)
    norms = (nm if use_m else nd).reshape(-1)[:ns]
    off = hp.KERNEL_LAYOUT
    pred = tabs[T_PREDEF:]
    st = pred[off[key + "_st"]: off[key + "_st"] + (1 << lm)].astype(np.int64)
    dnb = pred[off[key + "_dnb"]: off[key + "_dnb"] + ns].astype(np.int64)
    dfs = pred[off[key + "_dfs"]: off[key + "_dfs"] + ns].astype(np.int64)
    if use_m or use_d:
        t = lm if use_m else lg
        tab = 1 << t
        c = norms.astype(np.int64)
        cumul = np.cumsum(c) - c
        st = np.zeros(1 << lm, np.int64)
        st[:tab] = state_table(c, t)
        mbits = t - flog2(np.maximum(c - 1, 1))
        dnb = np.where(c == 0, ((t + 1) << 16) - tab,
                       np.where(c == 1, (t << 16) - tab,
                                (mbits << 16) - (c << np.clip(mbits, 0, 31))))
        dfs = np.where(c == 0, 0, np.where(c == 1, cumul - 1, cumul - c))
    flags = (rle_bit if rle else 0) | (fse_bit if use_m or use_d else 0) | \
        (lm << shift if use_m else 0) | (lg << shift if use_d else 0)
    gain = bits_pd - cost_m if use_m else (bits_pd - cost_d if use_d else 0)
    return flags, gain, st, dnb, dfs, norms, sym


def plan_all_mirror(hist, hist_q, lit_count, n_seq, const, lens, ll, ml,
                    offv, *, mode_huf, mode_huf1, mode_rawlit, mode_seq,
                    stats=None):
    """The kernel's outputs for numpy inputs: plan_blocks' six arrays then
    plan_seq_tables' five, int32."""
    stats = {} if stats is None else stats
    kw = dict(mode_huf=mode_huf, mode_huf1=mode_huf1,
              mode_rawlit=mode_rawlit, mode_seq=mode_seq)
    tabs = hp.plan_table().astype(np.int64)
    B, S = ll.shape
    out = [np.zeros(sh, np.int64) for sh in (
        (B,), (B,), (B, 256), (B, 32), (B,), (B, 4), (B,), (B, CTAB_W),
        (B, NORM_W), (B, 3), (B,))]
    (mode, mb, codes, wpk, rle, s4, sflags, ctabs, norms, rsyms,
     gain) = out
    off = hp.KERNEL_LAYOUT
    for r in range(B):
        (mode[r], mb[r], codes[r], wpk[r], rle[r], s4[r]) = huffman_row(
            hist[r], hist_q[r], int(lit_count[r]), int(lens[r]),
            int(const[r]), kw, stats)
        hs = seq_code_hists(ll[r], ml[r], offv[r], n_seq[r], S, tabs)
        for j, (stream, h) in enumerate(zip(STREAMS, hs)):
            f, g, st, dnb, dfs, nrm, sym = seq_table(h, int(n_seq[r]),
                                                     stream, tabs, stats)
            key, ns, no = stream[0], stream[1], stream[7]
            sflags[r] |= f
            gain[r] += g
            ctabs[r, off[key + "_st"]: off[key + "_st"] + len(st)] = st
            ctabs[r, off[key + "_dnb"]: off[key + "_dnb"] + ns] = dnb
            ctabs[r, off[key + "_dfs"]: off[key + "_dfs"] + ns] = dfs
            norms[r, no: no + ns] = nrm
            rsyms[r, j] = sym
    return tuple(o.astype(np.int32) for o in out)
