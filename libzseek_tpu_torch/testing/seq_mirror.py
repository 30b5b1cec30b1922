"""numpy mirror of the sequence lanes in csrc/fse_lanes.cu, used only by
tests.

A lane walks one FSE sequence stream backward for cnt = min(n, cap)
sequences: three table entries (sym | nb << 8 | base << 16) from its
tables of tabs (T, 512), the OF, ML and LL extra bits, the repcode step,
then (except after the lane's last sequence) the LL, ML and OF state
reads.  The kernel groups the lanes into blocks and stages their tables in
shared memory with ctab's extra-bit count and baseline folded into each
entry: the tagged arm (pass B) a block a lane, its stream staged too (the
words the walk can reach, for rows of up to SEQ_STAGE bytes); the
anchored arm (pass B') ANCHOR_THREADS lanes a block, the tables of its
first and last lanes staged.  A lane whose tables are not staged, or a
state outside [0, 512), reads the entry from tabs.

Each sequence's six fields are read at distances found by addition from
the 128 stream bits below pos, held as two 64-bit values (the stream's
bits with zeros below bit 0 and past the words held): the extra bits from
the top 64, the states from the 64 bits below their start.  A step
with an entry the window cannot serve (an offset code above 31 or a
state read above NARROW_NB bits: WIDE), with a state outside [0, 512) on
a staged lane, or whose position lies past the row's end reads its
entries from tabs and its fields through `read_at` / `read_wide`
(csrc/lane_bits.cuh) instead, so every value equals a walk through those
reads alone.
"""

from __future__ import annotations

import numpy as np

from libzseek_tpu_torch.ops.decode import CTAB

FSE_TAB = 512
REP_TAG = 1 << 20
N_LL, N_ML = 36, 53
C_LL_BITS, C_LL_BASE = 0, N_LL
C_ML_BITS, C_ML_BASE = 2 * N_LL, 2 * N_LL + N_ML
ANCHOR_THREADS = 64       # anchored lanes a block
SEQ_STAGE = 96 * 1024     # stream bytes a tagged block stages
NARROW_NB = 11            # the widest state read it serves
_M32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def read_at(row: np.ndarray, start: int, nb: int) -> int:
    """csrc/lane_bits.cuh read_at: bits [start, start + nb) from the LE32
    window at byte min(max(start, 0) >> 3, SB - 1); below bit 0 shifted up
    by min(-start, 31); nb >= 32 masks all 32 bits."""
    SB = row.shape[0]
    s0 = max(start, 0)
    q = min(s0 >> 3, SB - 1)
    w = int.from_bytes(row[q: q + 4].tobytes().ljust(4, b"\0"), "little")
    w >>= s0 & 7
    mask = _M32 if nb >= 32 else (1 << nb) - 1
    if start >= 0:
        return w & mask
    return ((w << min(-start, 31)) & _M32) & mask


def read_wide(row, start: int, nb: int) -> int:
    lo_nb = min(nb, 16)
    return (read_at(row, start, lo_nb)
            | (read_at(row, start + 16, nb - lo_nb) << 16)) & _M32


WIDE = 1 << 31            # entry flag: the window cannot serve it


def fold(k: int, e: int) -> int:
    """ctab's baseline | extra-bit count << 24 for table k's entry e (LL
    k = 0, ML k = 2; OF k = 1 has none), | WIDE where a window cannot
    serve the entry (a state read above NARROW_NB bits, an offset code
    above 31)."""
    c = e & 255
    wide = ((e >> 8) & 255) > NARROW_NB
    y = 0
    if k == 1:
        wide = wide or c > 31
    elif k == 0:
        c = min(c, N_LL - 1)
        y = int(CTAB[C_LL_BASE + c]) | int(CTAB[C_LL_BITS + c]) << 24
    else:
        c = min(c, N_ML - 1)
        y = int(CTAB[C_ML_BASE + c]) | int(CTAB[C_ML_BITS + c]) << 24
    return y | WIDE if wide else y


class _Tables:
    """A lane's three tables: staged (folded entries of its triple) or read
    from tabs; `stats` counts the entries read from tabs."""

    def __init__(self, flat, tid3, staged, stats):
        self.flat, self.staged, self.stats = flat, staged, stats
        self.b = [int(t) * FSE_TAB for t in tid3]

    def in_stage(self, *st) -> bool:
        """Whether a windowed step may read these states' entries: no
        staged tables, or every state inside them."""
        return not self.staged or all(0 <= s < FSE_TAB for s in st)

    def get(self, k: int, s: int) -> tuple[int, int]:
        if self.staged and 0 <= s < FSE_TAB:
            return self.staged[k][s]
        self.stats["global_entries"] += 1
        i = min(max(self.b[k] + s, 0), self.flat.size - 1)
        e = int(self.flat[i])
        return e, fold(k, e)


def stage(flat, tid3) -> list[list[tuple[int, int]]]:
    """A table triple's folded entries (clamped indices, as staged)."""
    out = []
    for k in range(3):
        idx = np.clip(int(tid3[k]) * FSE_TAB + np.arange(FSE_TAB), 0,
                      flat.size - 1)
        out.append([(int(e), fold(k, int(e))) for e in flat[idx]])
    return out


def _words(row: np.ndarray, nw: int):
    """Word i of the row (LE32) for 0 <= i < nw, else 0."""
    w = np.zeros(row.shape[0] // 4 + 1, np.int64)
    full = row[: 4 * (row.shape[0] // 4)].view("<u4").astype(np.int64)
    w[: full.size] = full
    return lambda i: int(w[i]) if 0 <= i < nw else 0


_M64 = (1 << 64) - 1


def window(word, p: int) -> tuple[int, int]:
    """(X, Y): the stream's bits [p - 64, p) and [p - 128, p - 64) as
    64-bit values, from the five words from floor32(p - 128)."""
    q = p - 128
    j, sh = q >> 5, q & 31
    v = sum(word(j + k) << (32 * k) for k in range(5)) >> sh
    return (v >> 64) & _M64, v & _M64


def _top(V: int, d: int, nb: int) -> int:
    """The nb bits that end d bits below the top of the 64-bit V."""
    return ((V >> 1) >> (63 - d)) & ((1 << nb) - 1)


def window_fields(word, pos: int, counts) -> tuple[int, ...]:
    """csrc/lane_bits.cuh window_fields: a windowed step's six fields
    (the OF, ML, LL extra bits, then the LL, ML, OF state bits; counts in
    that order, the first three summing to <= 63, the last three to <=
    33) from the 128 bits below pos."""
    ofc, mlb, llb, nll, nml, nof = counts
    X, Y = window(word, pos)
    d1, d2, d3 = ofc, ofc + mlb, ofc + mlb + llb
    xo, xm, xl = (_top(X, d, nb) for d, nb in (
        (d1, ofc), (d2, mlb), (d3, llb)))
    # the states from Z, the 64 bits below p3 = pos - d3
    Z = ((X << d3) | ((Y >> 1) >> (63 - d3))) & _M64
    e1, e2, e3 = nll, nll + nml, nll + nml + nof
    yl, ym, yo = (_top(Z, e, nb) for e, nb in (
        (e1, nll), (e2, nml), (e3, nof)))
    return xo, xm, xl, yl, ym, yo


def walk(row, word, T, pos, st, reps, n_l, cap, tagged, stats):
    """One lane: (ll, ml, off lists, (r1, r2, r3), ok)."""
    s_ll, s_of, s_ml = st
    r1, r2, r3 = reps
    cnt = min(n_l, cap)
    end_bits = 8 * row.shape[0]
    out = ([], [], [])
    for t in range(cnt):
        (ax, ay), (bx, by), (cx, cy) = (T.get(0, s_ll), T.get(1, s_of),
                                        T.get(2, s_ml))
        upd = t < n_l - 1
        ofc, mlb, llb = bx & 255, (cy >> 24) & 31, (ay >> 24) & 31
        nll, nml, nof = (((x >> 8) & 255) if upd else 0
                         for x in (ax, cx, bx))
        p1 = pos - ofc
        p2 = p1 - mlb
        p3 = p2 - llb
        p4 = p3 - nll
        p5 = p4 - nml
        p6 = p5 - nof
        fast = (T.in_stage(s_ll, s_of, s_ml)
                and not (ay | by | cy) & WIDE
                and pos <= end_bits)
        if fast:
            xo, xm, xl, yl, ym, yo = window_fields(
                word, pos, (ofc, mlb, llb, nll, nml, nof))
        else:
            stats["slow_steps"] += 1
            xo = read_wide(row, p1, ofc)
            xm = read_at(row, p2, mlb)
            xl = read_at(row, p3, llb)
            yl = ym = yo = 0
            if upd:
                yl = read_at(row, p4, nll)
                ym = read_at(row, p5, nml)
                yo = read_at(row, p6, nof)
        stats["steps"] += 1
        pos = p6
        ofv = _i32((1 << min(ofc, 30)) + xo)
        ml = (cy & 0xFFFFFF) + xm
        ll = (ay & 0xFFFFFF) + xl
        if tagged:
            idx = _i32(ofv + (ll == 0))
            if ofv > 3:
                off, r2, r3 = ofv - 3, r1, r2
            elif idx == 1:
                off = r1
            elif idx == 2:
                off, r2 = r2, r1
            elif idx == 3:
                off, r2, r3 = r3, r1, r2
            else:
                off, r2, r3 = r1 - 1, r1, r2
        else:
            off = ofv - 3 if ofv > 3 else r1
        r1 = off
        if upd:
            s_ll = (ax >> 16) + yl
            s_ml = (cx >> 16) + ym
            s_of = (bx >> 16) + yo
        for o, v in zip(out, (ll, ml, off)):
            o.append(v)
    return out, (r1, r2, r3), (pos == 0 if tagged else pos >= 0)


def seq_mirror(bank, sid, bits, n, states, rep1, tids, tls, tabs, cap,
               tagged, stats=None):
    """ops/lanes.seq_lanes as the kernel walks it: (ll, ml, off (L, cap)
    int32, zero past n; rep (L, 3) int32; ok (L,) bool).  stats, where
    given, gets the lanes, the steps, the steps read through read_at
    (slow_steps), the entries read from tabs, the lanes whose tables are
    not staged (global_lanes) and the tagged lanes whose stream is
    staged (staged_streams)."""
    bank = np.asarray(bank, np.uint8)
    NS, SB = bank.shape
    flat = np.asarray(tabs, np.int64).reshape(-1)
    flat = ((flat + (1 << 31)) & _M32) - (1 << 31)
    L = len(sid)
    out = [np.zeros((L, cap), np.int32) for _ in range(3)]
    rep = np.zeros((L, 3), np.int32)
    ok = np.zeros(L, bool)
    st = {"lanes": L, "steps": 0, "slow_steps": 0, "global_entries": 0,
          "global_lanes": 0, "staged_streams": 0}
    tids = np.asarray(tids, np.int64)
    staged_sets = {}
    for l in range(L):
        row = bank[min(max(int(sid[l]), 0), NS - 1)]
        nw = SB // 4
        pos = int(bits[l])
        if tagged:
            tl = [int(x) for x in tls[l]]
            pos0 = pos - sum(tl)
            if SB <= SEQ_STAGE:
                nw = min(nw, max(pos0, 0) // 32 + 4)
                st["staged_streams"] += 1
            sv = []
            for k in range(3):
                sv.append(read_at(row, pos - tl[k], tl[k]))
                pos -= tl[k]
            s_ll, s_of, s_ml = sv
            reps = (-REP_TAG, -2 * REP_TAG, -3 * REP_TAG)
            mine = stage(flat, tids[l])
        else:
            s_ll, s_of, s_ml = (int(x) for x in states[l])
            reps = (int(rep1[l]), 0, 0)
            first = l - l % ANCHOR_THREADS
            last = min(first + ANCHOR_THREADS, L) - 1
            mine = None
            for cand in (first, last):
                if tuple(tids[l]) == tuple(tids[cand]):
                    key = tuple(tids[cand])
                    if key not in staged_sets:
                        staged_sets[key] = stage(flat, tids[cand])
                    mine = staged_sets[key]
                    break
            if mine is None:
                st["global_lanes"] += 1
        T = _Tables(flat, tids[l], mine, st)
        (a, b, c), r, good = walk(row, _words(row, nw), T, pos,
                                  (s_ll, s_of, s_ml), reps, int(n[l]), cap,
                                  tagged, st)
        for o, v in zip(out, (a, b, c)):
            o[l, : len(v)] = v
        rep[l] = r
        ok[l] = good
    if stats is not None:
        stats.update(st)
    return out[0], out[1], out[2], rep, ok
