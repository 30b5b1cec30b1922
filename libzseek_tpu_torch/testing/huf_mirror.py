"""numpy mirror of the Huffman lanes in csrc/huf_lanes.cu, used only by
tests: the plain arm (one block a stream, split into pieces at guessed bit
offsets) and the anchored arm (a thread a chunk, the block's tables
staged, eight symbols out of four stream words; `huf_anchored_mirror` at
the end).

The plain arm decodes one Huffman stream a lane backward from its
sentinel bit `bits` for cnt = min(n, cap) symbols: at position q the
12-bit peek below q picks a table entry (sym, nb) and q -= nb.  Every
step is a function of q alone, so the walk splits by position.  The
positions in (0, bits] are cut into np <= PIECES pieces of w bits (np =
ceil(bits / PIECE_MIN_BITS), at most PIECES); piece j holds (lo_j, hi_j]
with hi_j = bits - j * w, and its thread first walks from hi_j (a
guess: only piece 0's is a code boundary) down to its exit, the first
position <= lo_j, recording the first RECORD positions.

Then rounds: the true entry of piece j is piece j-1's exit.  A piece
whose entry differs from the one it holds walks from the new entry,
comparing each position with its recorded ones: at the first equal
position the two walks agree from there on (Huffman codes
self-synchronise), so only the count changes; a walk that runs past the
recorded positions without meeting one walks the whole piece again from
the entry.  Rounds repeat until no entry changed (piece 0's never does,
so piece j is exact after at most j + 1 rounds).  An exclusive scan of
the counts places each piece's symbols; a piece walks once more to write
them.  Positions <= 0 read a peek of 0 (the reference's bits below 0 are
zeros), so past the last piece's exit the walk repeats entry 0: the
tail's symbols and final position follow in closed form.

A table with an entry whose nb is outside [1, 32], or bits past the
row's end, takes the serial walk (thread 0, a symbol a step).
"""

from __future__ import annotations

import numpy as np

HUF_PEEK = 12
PIECES = 128          # threads (pieces) a block
RECORD = 32           # positions a piece records
PIECE_MIN_BITS = 512  # the least bits a piece


def peek(row: np.ndarray, q: int) -> int:
    """The 12 bits below position q (csrc/lane_bits.cuh read_at(q - 12,
    12)): the LE32 window at byte min(s0 >> 3, SB - 1), s0 = max(q - 12,
    0); below bit 0 shifted up by min(12 - q, 31)."""
    SB = row.shape[0]
    start = q - HUF_PEEK
    s0 = max(start, 0)
    b = min(s0 >> 3, SB - 1)
    w = int.from_bytes(row[b: b + 4].tobytes().ljust(4, b"\0"), "little")
    w >>= s0 & 7
    if start >= 0:
        return w & 0xFFF
    return ((w << min(-start, 31)) & 0xFFFFFFFF) & 0xFFF


def stream_table(dtabs: np.ndarray, tid: int) -> np.ndarray:
    """The 4,096 entries a lane with table tid reads (its indices clamped
    to dtabs, as the kernel stages them)."""
    flat = np.asarray(dtabs, np.int64).reshape(-1)
    k = np.clip((int(tid) << HUF_PEEK) + np.arange(1 << HUF_PEEK), 0,
                flat.size - 1)
    return flat[k]


def serial(row, bits, cnt, tab):
    """The one-thread walk: (symbols, final position)."""
    q, out = int(bits), []
    for _ in range(cnt):
        e = int(tab[peek(row, q)])
        out.append(e & 255)
        q -= e >> 8
    return out, q


def _walk(row, tab, q, lo, rec=None):
    """Positions from q while q > lo: (count, exit); the first RECORD
    positions appended to rec."""
    c = 0
    while q > lo:
        if rec is not None and c < RECORD:
            rec.append(q)
        q -= int(tab[peek(row, q)]) >> 8
        c += 1
    return c, q


def _resync(row, tab, t, lo, rec, c_walk):
    """Walk from entry t against the recorded positions: (count from t)
    when it meets one, else None (the piece walks again from t)."""
    q, i, steps = t, 0, 0
    while q > lo:
        while i < len(rec) and rec[i] > q:
            i += 1
        if i == len(rec):
            return None
        if rec[i] == q:
            return steps + c_walk - i
        q -= int(tab[peek(row, q)]) >> 8
        steps += 1
    return None


def pieces(row, bits, n, cap, tab, stats=None):
    """One plain-arm stream as the kernel walks it: (symbols (cap,)
    uint8, zero past cnt; final position).  `stats`, where given, gets
    the pieces, rounds, resyncs (walks that met a recorded position) and
    rewalks (pieces walked again), and whether the serial walk ran."""
    row = np.asarray(row, np.uint8)
    out = np.zeros(cap, np.uint8)
    cnt = max(min(int(n), cap), 0)
    bits = int(bits)
    nb = np.asarray(tab, np.int64) >> 8
    st = {"pieces": 0, "rounds": 0, "resyncs": 0, "rewalks": 0,
          "serial": False}
    if stats is not None:
        stats.update(st)
        st = stats
    if ((nb < 1) | (nb > 32)).any() or bits > 8 * row.shape[0]:
        st["serial"] = True
        syms, q = serial(row, bits, cnt, tab)
        out[: len(syms)] = syms
        return out, q
    if cnt == 0:
        return out, bits
    npc = min(PIECES, -(-bits // PIECE_MIN_BITS)) if bits > 0 else 0
    st["pieces"] = npc
    w = -(-bits // npc) if npc else 0
    hi = [bits - j * w for j in range(npc)]
    lo = [max(bits - (j + 1) * w, 0) for j in range(npc)]
    rec = [[] for _ in range(npc)]
    walk = [_walk(row, tab, hi[j], lo[j], rec[j]) for j in range(npc)]
    c_walk = [c for c, _ in walk]
    x = [q for _, q in walk]
    entry = list(hi)
    count = list(c_walk)
    while True:
        st["rounds"] += 1
        xs = list(x)             # the exits as the last round left them
        changed = False
        for j in range(1, npc):
            t = xs[j - 1]
            if t == entry[j]:
                continue
            changed = True
            got = _resync(row, tab, t, lo[j], rec[j], c_walk[j])
            entry[j] = t
            if got is not None:
                st["resyncs"] += 1
                count[j] = got
            else:
                st["rewalks"] += 1
                rec[j] = []
                c_walk[j], x[j] = _walk(row, tab, t, lo[j], rec[j])
                count[j] = c_walk[j]
        if not changed:
            break
    off = np.concatenate([[0], np.cumsum(count)]).astype(np.int64)
    S = int(off[-1])
    fin = None
    for j in range(npc):
        q = entry[j]
        for k in range(count[j]):
            e = int(tab[peek(row, q)])
            q -= e >> 8
            idx = int(off[j]) + k
            if idx < cnt:
                out[idx] = e & 255
            if idx == cnt - 1:
                fin = q
    if S < cnt:
        x_last = x[npc - 1] if npc else bits
        e0 = int(tab[0])
        out[S:cnt] = e0 & 255
        fin = x_last - (cnt - S) * (e0 >> 8)
    return out, fin


def huf_plain_mirror(bank, sid, bits, n, tid, dtabs, cap, stats=None):
    """huf_lanes(..., exact=True) through `pieces`, lane by lane: (syms
    (L, cap) uint8, ok (L,) bool: every bit consumed).  stats, where
    given, becomes a list of each lane's stats."""
    bank = np.asarray(bank, np.uint8)
    NS = bank.shape[0]
    L = len(sid)
    syms = np.zeros((L, cap), np.uint8)
    ok = np.zeros(L, bool)
    for l in range(L):
        s = min(max(int(sid[l]), 0), NS - 1)
        st = {}
        syms[l], q = pieces(bank[s], bits[l], n[l], cap,
                            stream_table(dtabs, tid[l]), st)
        ok[l] = q == 0
        if stats is not None:
            stats.append(st)
    return syms, ok


# --- the anchored arm: a thread a chunk lane, the block's tables staged ---

ANCHOR_THREADS = 128   # chunk lanes a block
GROUP = 8              # symbols a window serves
GROUP_NB = 12          # the longest code a staged table holds
GROUP_BITS = GROUP * GROUP_NB


def staged_table(dtabs, tid) -> np.ndarray | None:
    """Table tid as the anchored arm stages it (sym | nb << 8 in uint16),
    or None where an entry's nb lies outside [0, GROUP_NB]."""
    tab = stream_table(dtabs, tid)
    tab = ((tab + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)   # int32 entries
    nb = tab >> 8
    if ((nb < 0) | (nb > GROUP_NB)).any():
        return None
    return (nb << 8) | (tab & 255)


def group_walk(row: np.ndarray, pos: int, cnt: int, tab, stats) -> tuple:
    """A staged lane: GROUP symbols at a time out of the four words from
    floor32(pos - GROUP_BITS - 1) (zeros below bit 0 and past the row):
    (symbols, final position)."""
    n = row.shape[0] // 4
    w = row[: 4 * n].view("<u4").astype(np.int64)
    word = lambda i: int(w[i]) if 0 <= i < n else 0
    out = []
    for t0 in range(0, cnt, GROUP):
        wi = (pos - GROUP_BITS - 1) >> 5
        win = [word(wi + k) for k in range(4)] + [0]
        stats["windows"] += 1
        for _ in range(min(GROUP, cnt - t0)):
            o = pos - HUF_PEEK - (wi << 5)
            i = o >> 5
            v = (((win[i + 1] << 32) | win[i]) >> (o & 31)) & 0xFFF
            e = int(tab[v])
            out.append(e & 255)
            pos -= e >> 8
    return out, pos


def huf_anchored_mirror(bank, sid, bits, n, tid, dtabs, cap, stats=None):
    """huf_lanes(..., exact=False) as the kernel walks it: (syms (L, cap)
    uint8, zero past n; ok (L,) bool: the walk stayed at or above bit 0).
    stats, where given, gets the lanes, the lanes on a staged table, the
    symbols and the windows loaded."""
    bank = np.asarray(bank, np.uint8)
    NS, SB = bank.shape
    L = len(sid)
    syms = np.zeros((L, cap), np.uint8)
    ok = np.zeros(L, bool)
    st = {"lanes": L, "staged_lanes": 0, "symbols": 0, "windows": 0}
    flat = np.asarray(dtabs, np.int64).reshape(-1)
    flat = ((flat + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    last = flat.size - 1
    for first in range(0, L, ANCHOR_THREADS):
        lastl = min(first + ANCHOR_THREADS, L) - 1
        sets = {}
        for t in (int(tid[first]), int(tid[lastl])):
            sets.setdefault(t, staged_table(dtabs, t))
        for l in range(first, lastl + 1):
            row = bank[min(max(int(sid[l]), 0), NS - 1)]
            tab = sets.get(int(tid[l]))
            pos = int(bits[l])
            cnt = min(int(n[l]), cap)
            if tab is None or pos > 8 * SB:
                # a symbol a step through read_at's peek
                tbase = int(tid[l]) << HUF_PEEK
                for t in range(cnt):
                    e = int(flat[min(max(tbase + peek(row, pos), 0), last)])
                    syms[l, t] = e & 255
                    pos -= e >> 8
            else:
                st["staged_lanes"] += 1
                out, pos = group_walk(row, pos, cnt, tab, st)
                syms[l, : len(out)] = out
            st["symbols"] += max(cnt, 0)
            ok[l] = pos >= 0
    if stats is not None:
        stats.update(st)
    return syms, ok
