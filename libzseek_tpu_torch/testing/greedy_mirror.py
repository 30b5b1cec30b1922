"""numpy mirror of csrc/greedy_select.cu's walk, used only by tests.

A segment k is selected under the cover end c iff c <= T[k], with

    T[k] = min(e[k] - min_match, tail)   if has[k], e[k] - p[k] >= min_match
                                         and p[k] <= tail,
    T[k] = -inf                          otherwise

(tail = lengths - min_tail): for c <= p the start is p and the test does
not depend on c; for c > p the start is c.  So `ok` can only turn false
as c grows.  The kernel walks rounds of 32 consecutive segments, one a
lane: a ballot under the round's c is a superset of the round's
selections; the round takes its lowest set lane j (its match is
selected) and the run of lanes after it that are each selected under
the e of the lane before (a second ballot), sets c to the run's last e,
clears the lanes up to it, ANDs the mask with a fresh ballot under the
new c, and repeats until the mask is empty (a step a run).  A lane's lit_from is the e of the highest selected lane below it
(or the round's c), and its start max(p, lit_from).

Each row is split into chunks, one a warp of its CUDA block (WARPS of
at least MIN_CHUNK segments, a multiple of 32).  Chunk 0 walks from c0;
chunk i > 0 from a guess g (the previous segment's e where it has a
candidate, else its own p), keeping its first selection kf, the largest
T before it and T[kf].  The walk from another entry c' agrees with it
from kf on iff max(T before kf) < c' <= T[kf] (without a selection:
max(T) < c', and the exit is c').  One thread then resolves the true
entries chunk after chunk by that test; a chunk that fails it walks
again from its true entry, comparing each segment's c with its stored
lit_from: at the first equal one the walks agree from there on, so only
the segments before it are rewritten and the exit stays; a walk that
never meets the stored one rewrites the chunk and changes its exit.
Last, each chunk whose true entry differs from its guess rewrites
lit_from and start up to kf.

greedy_rounds walks row by row as the kernel's block does; its stats
count the chunks, the selection steps, the chunks walked again, the
segments those walks took and the segments the last pass rewrote.
"""

from __future__ import annotations

import numpy as np

LANES = 32
WARPS = 32       # chunks a row (the kernel's warps a block)
MIN_CHUNK = 256  # the least segments a chunk
_NEG = np.iinfo(np.int64).min


def thresholds(p, e, has, tail, min_match: int):
    """(B, n) int64 T: the largest cover end under which each segment is
    still selected, or int64 min where it never is."""
    p, e = np.asarray(p, np.int64), np.asarray(e, np.int64)
    tail = np.asarray(tail, np.int64)[:, None]
    good = np.asarray(has, bool) & (e - p >= min_match) & (p <= tail)
    return np.where(good, np.minimum(e - min_match, tail), _NEG)


def round_walk(Tr, Er, c):
    """One round of 32 lanes (T and e as (32,) int64) from cover end c:
    (selected lanes (32,) bool, lit_from (32,) int64, c after, steps: the
    runs selected)."""
    lane = np.arange(LANES)
    cr = c
    mask = c <= Tr                      # the round's ballot
    # lane k is selected right after lane k - 1 (tested under its e)
    nxt = np.concatenate([[False], Er[:-1] <= Tr[1:]])
    selm = np.zeros(LANES, bool)
    steps = 0
    while mask.any():
        j = int(np.argmax(mask))         # the lowest set lane
        jj = j                           # and its run of such lanes
        while jj + 1 < LANES and nxt[jj + 1]:
            jj += 1
        selm[j: jj + 1] = True
        c = int(Er[jj])
        steps += 1
        mask &= (lane > jj) & (c <= Tr)
    # lit_from: the e of the highest selected lane below, else cr
    run = np.maximum.accumulate(np.where(selm, Er, _NEG))
    prev = np.concatenate([[_NEG], run[:-1]])
    return selm, np.where(prev == _NEG, cr, prev), c, steps


def chunking(nseg: int) -> tuple[int, int]:
    """(segments a chunk, chunks) of a row, as the kernel cuts it."""
    chunk = max(MIN_CHUNK, (-(-nseg // WARPS) + 31) & ~31)
    return chunk, -(-nseg // chunk)


def greedy_rounds(p, e, has, lengths, min_tail: int, min_match: int,
                  c0: int, stats: dict | None = None):
    """The kernel's walk on (B, nseg) numpy arrays: (sel bool, start,
    lit_from (B, nseg) int64, c_final (B,) int64), equal to
    greedy_select's.  `stats`, where given, receives chunks, steps
    (a round's steps, one a run of selections, summed), max_chunk_steps (the most of one chunk's
    first walk), rewalks (chunks walked again), rewalk_segments, filled
    (segments the last pass rewrote) and selections."""
    P = np.asarray(p, np.int64)
    E = np.asarray(e, np.int64)
    H = np.asarray(has, bool)
    B, nseg = P.shape
    T = thresholds(P, E, H, np.asarray(lengths, np.int64) - min_tail,
                   min_match)
    sel = np.zeros((B, nseg), bool)
    lit = np.zeros((B, nseg), np.int64)
    cfin = np.full(B, c0, np.int64)
    st = {"chunks": 0, "steps": 0, "max_chunk_steps": 0, "rewalks": 0,
          "rewalk_segments": 0, "filled": 0}
    chunk, nch = chunking(nseg) if nseg else (MIN_CHUNK, 0)
    bounds = [(w * chunk, min(nseg, (w + 1) * chunk)) for w in range(nch)]

    def lanes(b, r0, k1):
        n = min(LANES, k1 - r0)
        Tr = np.full(LANES, _NEG)
        Er = np.zeros(LANES, np.int64)
        Tr[:n] = T[b, r0: r0 + n]
        Er[:n] = E[b, r0: r0 + n]
        return n, Tr, Er

    for b in range(B):
        g, kf, mpre, tkf, exits = [], [], [], [], []
        for w, (k0, k1) in enumerate(bounds):
            c = c0 if w == 0 else int(E[b, k0 - 1] if H[b, k0 - 1]
                                      else P[b, k0])
            g.append(c)
            f, m, tf, steps = k1, _NEG, _NEG, 0
            for r0 in range(k0, k1, LANES):
                n, Tr, Er = lanes(b, r0, k1)
                selm, lf, c, s = round_walk(Tr, Er, c)
                steps += s
                if f == k1:      # no selection yet: the entry's reach
                    j0 = int(np.argmax(selm)) if selm.any() else LANES
                    m = max(m, int(Tr[:j0].max(initial=_NEG)))
                    if selm.any():
                        f, tf = r0 + j0, int(Tr[j0])
                sel[b, r0: r0 + n] = selm[:n]
                lit[b, r0: r0 + n] = lf[:n]
            kf.append(f)
            mpre.append(m)
            tkf.append(tf)
            exits.append(c)
            st["steps"] += steps
            st["max_chunk_steps"] = max(st["max_chunk_steps"], steps)
        st["chunks"] += nch
        true = list(g)
        c = exits[0] if nch else c0
        for w in range(1, nch):
            k0, k1 = bounds[w]
            true[w] = c
            if mpre[w] < c and (kf[w] == k1 or c <= tkf[w]):
                if kf[w] < k1:
                    c = exits[w]
                continue
            # walk again from the true entry until it meets the stored walk
            st["rewalks"] += 1
            met = False
            for r0 in range(k0, k1, LANES):
                n, Tr, Er = lanes(b, r0, k1)
                selm, lf, c, _ = round_walk(Tr, Er, c)
                st["rewalk_segments"] += n
                same = np.flatnonzero(lf[:n] == lit[b, r0: r0 + n])
                upto = int(same[0]) if same.size else n
                sel[b, r0: r0 + upto] = selm[:upto]
                lit[b, r0: r0 + upto] = lf[:upto]
                if same.size:
                    met = True
                    break
            if met:
                c = exits[w]
            g[w] = true[w]
        for w in range(1, nch):
            if true[w] != g[w]:
                k0, k1 = bounds[w]
                kend = kf[w] + 1 if kf[w] < k1 else k1
                lit[b, k0: kend] = true[w]
                st["filled"] += kend - k0
        if nch:
            cfin[b] = c
    start = np.maximum(P, lit)
    st["selections"] = int(sel.sum())
    if stats is not None:
        stats.update(st)
    return sel, start, lit, cfin
