"""K1: linked-block gated zstd parse, every level.

Counterpart of libzseek_tpu/ops/pallas_match.py zstd_parse_linked_smem
(:853), which runs the Pallas kernel _parse_linked_kernel (:194, the
pallas_call at :914).  The CUDA kernel is csrc/parse_linked.cu; the plain
version below is the same walk in Python ints and runs only for tensors
on the CPU.  The kernel walks each chain on one warp: a dual-arm miss
run probes 32 positions at once, and extensions compare 32 words a step.
run_positions, lane_hashes, miss_run, lane_extend and lane_back_extend
at the end of this module mirror those warp phases; only the tests call
them.

The arms, as level_search_params (ops/zstd_encode.py) picks them:
- levels <= 3: one 2^16-entry table, the quad miss loop with its
  single-step head and tail, the strict (8-byte hash) and non-strict
  (5-byte hash) arms chosen per row by 6*h16 <= 480, the in-kernel gate
  with gated_policy "halve", min_match 5 or 6, accel_log 5 or 6;
- levels >= 4 add `dual` (the table splits into a 2^15-entry short half
  hashed on 5 bytes, at offset 0, and a 2^14-entry long quarter hashed on
  8 bytes, at offset 2^15; every position probes and seeds both and the
  long candidate wins; in strict rows a short-only candidate confirms on
  4 bytes, `short4`), `lazy` 1 or 2 (after a confirmed hit, probe ip+1,
  seeding the table there, and take a strictly longer confirmed match;
  the second step probes from the updated ip), `rep_probe` (at every
  position the previous kept match's distance is tried before the
  table) and the single-step loop instead of the quad loop.  The
  reference reaches rep_probe without dual only through its quad loop,
  which only the retired ZN_REP_PROBE knob selects: that arm raises.

Both walk one chain of rows per frame: a chain starts at every row whose
min_abs fences off the previous row.  The reference keeps one table for
the whole grid; a fresh table per chain gives the same output because a
stale entry behaves exactly like an empty slot (-1) everywhere it is
read.  Entries are {tag:7, pos:24} and a probe at absolute position pos
accepts an entry e only if tagb + wlo <= e < tagb + pos, where
wlo >= min_abs of the row.  A stale entry was written by an earlier
chain, at a position below (r0+1)*N for the chain's first row r0, and
every row of the chain has min_abs >= (r0+1)*N: with the probe's tag it
fails e >= tagb + wlo; with another tag it lies outside the 24-bit range
[tagb, tagb + 2^24) (positions stay below 2^24, _check).  That holds for
each of the two dual sub-tables with its own tag, and for the lazy probe
(which checks the same range at ip+1, and only reads the entry when the
check passes).  The repcode state restarts at 0 in every row, so
rep_probe carries nothing across rows either.
"""

from __future__ import annotations

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError

HASH_LOG = 16
TAB_SIZE = 1 << HASH_LOG
CAP = 8192
MAX_OFFSET = (1 << 17) - 1
STRICT_H16_X6 = 480
UNWRITTEN = -(1 << 31)     # slots the walk never wrote (reference fill)

_PRIME = np.uint32(2654435761)
_GOLD = np.uint32(0x9E3779B1)

launches = 0


def chain_bounds(min_abs: np.ndarray, N: int) -> np.ndarray:
    """Row ranges walked in order with one table: [b[c], b[c+1])."""
    B = len(min_abs)
    starts = [i for i in range(B) if i == 0 or min_abs[i] >= (i + 1) * N]
    return np.asarray(starts + [B], np.int32)


def _check(x2, lengths, min_abs, h16, dual, rep_probe):
    if rep_probe and not dual:
        raise ParameterError(
            "rep_probe without dual is the quad loop's repcode arm, which "
            "only the retired ZN_REP_PROBE knob reaches: not ported")
    B1, N = x2.shape
    B = B1 - 1
    if x2.dtype != torch.uint8 or N % 32:
        raise ValueError("x2 must be (B+1, N) uint8 with N % 32 == 0")
    if B1 * N > (1 << 24):
        raise ValueError("batch too large for tagged-table positions")
    for t in (lengths, min_abs, h16):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise ValueError("lengths, min_abs, h16 must be (B,) int32")
    ma = min_abs.cpu().numpy()
    if (ma < np.arange(B) * N).any():
        raise ValueError("min_abs must not reach before the previous row")
    return B, N, ma


def parse_linked(x2: torch.Tensor, lengths: torch.Tensor,
                 min_abs: torch.Tensor, h16: torch.Tensor, *,
                 gate_bits: int = 14, min_match: int = 5,
                 accel_log: int = 6, lazy: int = 0, dual: bool = False,
                 rep_probe: bool = False):
    """x2: (B+1, N) uint8, row r+1 = block r and row r its context;
    lengths, min_abs, h16 (B,) int32 (contract of the reference wrapper).
    Returns (ll, ml, offv (B, 8192), n_seq, cover_end (B,), lit_mask
    (B, N//32)), all int32; the gate is applied, slots past n_seq hold
    whatever the walk left there."""
    B, N, ma = _check(x2, lengths, min_abs, h16, dual, rep_probe)
    prm = (gate_bits, min_match, accel_log, int(lazy), bool(dual),
           bool(rep_probe))
    if x2.device.type == "cpu":
        return _parse_plain(x2, lengths, h16, B, N, ma, prm)
    return _parse_cuda(x2, lengths, min_abs, h16, B, N, ma, prm)


def _parse_cuda(x2, lengths, min_abs, h16, B, N, ma, prm):
    global launches
    from libzseek_tpu_torch import kernels
    gate_bits, min_match, accel_log, lazy, dual, rep_probe = prm
    dev = x2.device
    x2 = x2.contiguous()
    bounds = torch.from_numpy(chain_bounds(ma, N)).to(dev)
    nch = bounds.numel() - 1
    # the dual table lives in the kernel's shared memory
    tables = torch.empty((0 if dual else nch, TAB_SIZE), dtype=torch.int32,
                         device=dev)
    ll = torch.empty((B, CAP), dtype=torch.int32, device=dev)
    ml = torch.empty_like(ll)
    off = torch.empty_like(ll)
    nn = torch.empty((B, 2), dtype=torch.int32, device=dev)
    mask = torch.empty((B, N // 32), dtype=torch.int32, device=dev)
    ins = [t.contiguous() for t in (lengths, min_abs, h16)]
    kernels.launch(
        "zk_parse_linked", dev, x2.data_ptr(), ins[0].data_ptr(),
        ins[1].data_ptr(), ins[2].data_ptr(), bounds.data_ptr(), nch, N, CAP,
        MAX_OFFSET, gate_bits, min_match, accel_log, STRICT_H16_X6, lazy,
        int(dual), int(rep_probe), tables.data_ptr(), ll.data_ptr(),
        ml.data_ptr(), off.data_ptr(), nn.data_ptr(), mask.data_ptr())
    launches += 1
    return ll, ml, off, nn[:, 0], nn[:, 1], mask


# --------------------------------------------------------------------
# plain version: the same walk in Python ints


def _bucket_tag(u: np.ndarray, tlog: int, off: int):
    """Bucket (tlog bits, + off) and pre-shifted 7-bit tag of hash
    products u, as the reference's h_tagb / h_tagb_sub."""
    h = (u >> np.uint32(32 - tlog)).astype(np.int64) + off
    tagb = ((u << np.uint32(tlog - 1)) & np.uint32(0x7F000000)) \
        .astype(np.int64)
    return h.tolist(), tagb.tolist()


def _row_hashes(win: np.ndarray, strict: bool, dual: bool):
    """(bucket, tagb) lists of every window position for the row's table,
    with the reference's clamped loads (words past the window end repeat
    the last word): the one 2^16 table, or with `dual` the short half and
    then the long quarter."""
    words = win.view("<u4")
    WW = len(words)
    p = np.arange(4 * WW)
    q = p >> 2
    sh = ((p & 3) * 8).astype(np.uint32)
    lo = words[q]
    hi = words[np.minimum(q + 1, WW - 1)]
    w3 = words[np.minimum(q + 2, WW - 1)]
    nz = (np.uint32(32) - sh) & np.uint32(31)
    w = np.where(sh == 0, lo, (lo >> sh) | (hi << nz))
    ext4 = np.where(sh == 0, hi, (hi >> sh) | (w3 << nz))
    # the reference's sig_u: 8 bytes (strict) or 5 bytes; with dual the
    # short half passes only ext4's low byte, through the same function
    ext = (ext4 & np.uint32(0xFF)) if dual or not strict else ext4
    if strict:
        u = (w ^ (ext * _GOLD)) * _PRIME
    else:
        u = (w ^ (ext << np.uint32(13))) * _PRIME
    if not dual:
        return _bucket_tag(u, HASH_LOG, 0), None
    u_long = (w ^ (ext4 * _GOLD)) * _PRIME
    return (_bucket_tag(u, HASH_LOG - 1, 0),
            _bucket_tag(u_long, HASH_LOG - 2, 1 << (HASH_LOG - 1)))


def _parse_plain(x2, lengths, h16, B, N, ma, prm):
    xs = x2.numpy()
    lens = lengths.numpy().tolist()
    h16s = h16.numpy().tolist()
    ma = ma.tolist()
    ll_o = np.full((B, CAP), UNWRITTEN, np.int64)
    ml_o = np.full((B, CAP), UNWRITTEN, np.int64)
    off_o = np.full((B, CAP), UNWRITTEN, np.int64)
    nn = np.zeros((B, 2), np.int64)
    mask_o = np.zeros((B, N // 32), np.uint32)
    bounds = chain_bounds(np.asarray(ma), N).tolist()
    for c in range(len(bounds) - 1):
        table = [-1] * TAB_SIZE
        for r in range(bounds[c], bounds[c + 1]):
            out = _parse_row_plain(xs[r: r + 2].reshape(-1), table, N,
                                   lens[r], r * N, ma[r], h16s[r], prm)
            cnt, cover, writes, mask = out
            for k, (a, b, o) in writes.items():
                ll_o[r, k], ml_o[r, k], off_o[r, k] = a, b, o
            nn[r] = (cnt, cover)
            mask_o[r] = mask
    t = lambda a: torch.from_numpy(a.astype(np.int32))
    return (t(ll_o), t(ml_o), t(off_o), t(nn[:, 0]), t(nn[:, 1]),
            torch.from_numpy(mask_o.view(np.int32).copy()))


def _parse_row_plain(win, table, N, blen, base, min_abs, h16, prm):
    gate_bits, min_match, accel_log, lazy, dual, rep_probe = prm
    limit = N + blen - 12
    lim = N + blen
    mask = [0xFFFFFFFF] * (N // 32)
    writes: dict[int, tuple[int, int, int]] = {}
    if limit <= N:
        return 0, 0, writes, mask
    strict = 6 * h16 <= STRICT_H16_X6
    (H, T), long_tab = _row_hashes(win, strict, dual)
    HL, TL = long_tab if dual else (H, T)
    wb = win.tobytes()
    max_offset = MAX_OFFSET
    cheap_bits = max(gate_bits - 6, 6) * 16

    def insert_at(p):
        if dual:
            table[HL[p]] = (base + p) | TL[p]
        table[H[p]] = (base + p) | T[p]

    def extend(ip, cand):
        l = 4
        while ip + l + 64 <= lim and \
                wb[ip + l: ip + l + 64] == wb[cand + l: cand + l + 64]:
            l += 64
        while ip + l + 4 <= lim and \
                wb[ip + l: ip + l + 4] == wb[cand + l: cand + l + 4]:
            l += 4
        for _ in range(3):
            if ip + l < lim and wb[ip + l] == wb[cand + l]:
                l += 1
            else:
                break
        return l

    def clear_mask(ips, lf):
        a = ips - N
        eend = a + lf
        wa, we = a >> 5, (eend - 1) >> 5
        lowm = (1 << (a & 31)) - 1
        eb = eend & 31
        highm = 0 if eb == 0 else (0xFFFFFFFF << eb) & 0xFFFFFFFF
        mask[wa] &= (lowm | highm) if wa == we else lowm
        if we > wa:
            mask[we] &= highm
        for wk in range(wa + 1, we):
            mask[wk] = 0

    def lazy_steps(ip, cand_abs, l):
        """Probe ip+1 up to `lazy` times (seeding the table there); a
        strictly longer confirmed match moves the match there."""
        for _ in range(lazy):
            if ip + 1 >= limit:
                continue
            p2 = ip + 1
            h2, tb2 = HL[p2], TL[p2]      # the long quarter with dual
            e2 = table[h2]
            pos2 = base + p2
            wlo2 = max(min_abs, pos2 - max_offset)
            table[h2] = pos2 | tb2
            if tb2 + wlo2 <= e2 < tb2 + pos2:
                c2_abs = e2 & 0xFFFFFF
                c2 = c2_abs - base
                if wb[c2: c2 + 4] == wb[p2: p2 + 4]:
                    l2 = extend(p2, c2)
                    if l2 > l:
                        ip, cand_abs, l = p2, c2_abs, l2
        return ip, cand_abs, l

    def match_full(st, ip, cand_abs, conf):
        _, anchor, cnt, miss, rep = st
        l = extend(ip, cand_abs - base)
        if conf and lazy:
            ip, cand_abs, l = lazy_steps(ip, cand_abs, l)
        cand = cand_abs - base
        dist = base + ip - cand_abs
        le = l if conf else 2
        nins = min(le >> 5, 8)
        stp = le // max(nins, 1)
        for k in range(1, nins):
            insert_at(ip + k * stp)
        insert_at(ip + le - 2)
        minw = min_abs - base
        kb = 0
        while ip - kb > anchor and cand - kb > minw and \
                wb[ip - kb - 1] == wb[max(cand - kb - 1, 0)]:
            kb += 1
        ips = ip - kb
        lf = l + kb
        ebits = (dist + 3).bit_length() - 1
        cheap = dist == rep and cnt > 0 and ips > anchor
        keep = conf and lf >= (4 if cheap else min_match) and \
            lf * h16 > (cheap_bits if cheap else (gate_bits + ebits) * 16)
        writes[cnt] = (ips - anchor, lf, dist + 3)
        if keep:
            clear_mask(ips, lf)
            return [ip + l, ip + l, cnt + 1, 0, dist]
        ipn = ip + l if conf else ip + 1 + (miss >> accel_log)
        return [ipn, anchor, cnt, (miss >> 1) if conf else miss + 1, rep]

    def match_at(st, ip, cand_abs, short4=False):
        _, anchor, cnt, miss, rep = st
        cand = cand_abs - base
        conf4 = wb[cand: cand + 4] == wb[ip: ip + 4]
        if strict:
            conf = conf4 and wb[cand + 4: cand + 8] == wb[ip + 4: ip + 8]
            conf = conf or (conf4 and base + ip - cand_abs == rep
                            and cnt > 0)
            conf = conf or (conf4 and short4)
            return match_full(st, ip, cand_abs, conf)
        a, b = wb[cand + 4: cand + 8], wb[ip + 4: ip + 8]
        l8 = 8
        for j in range(4):
            if a[j] != b[j]:
                l8 = 4 + j
                break
        dist = base + ip - cand_abs
        ebits = (dist + 3).bit_length() - 1
        cheap8 = dist == rep and cnt > 0
        prof8 = l8 >= (4 if cheap8 else min_match) and \
            l8 * h16 > (cheap_bits if cheap8 else (gate_bits + ebits) * 16)
        bk0 = ip > anchor and cand > min_abs - base and \
            wb[ip - 1] == wb[max(cand - 1, 0)]
        if conf4 and l8 < 8 and not prof8 and not bk0:
            insert_at(ip + l8 - 2)
            return [ip + l8, anchor, cnt, miss >> 1, rep]
        return match_full(st, ip, cand_abs, conf4)

    def body1(st):
        ip, anchor, cnt, miss, rep = st
        pos = base + ip
        wlo = max(min_abs, pos - max_offset)
        h, tb = H[ip], T[ip]
        e = table[h]
        table[h] = pos | tb
        if tb + wlo <= e < tb + pos and cnt < CAP:
            return match_at(st, ip, e & 0xFFFFFF)
        return [ip + 1 + (miss >> accel_log), anchor, cnt, miss + 1, rep]

    def body1_dual(st):
        ip, anchor, cnt, miss, rep = st
        pos = base + ip
        wlo = max(min_abs, pos - max_offset)
        rep_hit = rep_probe and rep > 0 and cnt < CAP and \
            wb[max(ip - rep, 0): max(ip - rep, 0) + 4] == wb[ip: ip + 4]
        hs, ts, hl, tl = H[ip], T[ip], HL[ip], TL[ip]
        e_s, e_l = table[hs], table[hl]
        good_l = tl + wlo <= e_l < tl + pos
        good_s = ts + wlo <= e_s < ts + pos
        table[hs] = pos | ts
        table[hl] = pos | tl
        if rep_hit:
            return match_at(st, ip, pos - rep)
        if (good_l or good_s) and cnt < CAP:
            return match_at(st, ip, (e_l if good_l else e_s) & 0xFFFFFF,
                            short4=not good_l)
        return [ip + 1 + (miss >> accel_log), anchor, cnt, miss + 1, rep]

    st = [N, N, 0, 0, 0]
    if dual:
        # the dual arms single-step (the reference's run_single)
        while st[0] < limit:
            st = body1_dual(st)
        return st[2], st[1] - N, writes, mask

    qlim = N + blen - 16
    qshift = accel_log + 2
    while st[0] < limit:
        while st[0] < limit and st[0] & 3:
            st = body1(st)
        q = st[0] >> 2
        qp = q
        fnd = 0
        missq = st[3]
        es = None
        while fnd == 0 and 4 * q <= qlim:
            p = 4 * q
            pos0 = base + p
            wlo = max(min_abs, pos0 - (max_offset - 3))
            es = []
            for k in range(4):
                h, tb = H[p + k], T[p + k]
                e = table[h]
                table[h] = (pos0 + k) | tb
                if tb + wlo <= e < tb + pos0 + k:
                    fnd |= 1 << k
                es.append(e)
            qp = q
            q = q + 1 + (missq >> qshift)
            missq += 4
        st[3] = missq
        if fnd and st[2] < CAP:
            k = (fnd & -fnd).bit_length() - 1
            st = match_at(st, 4 * qp + k, es[k] & 0xFFFFFF)
        else:
            st[0] = 4 * q
            while st[0] < limit:
                st = body1(st)
    return st[2], st[1] - N, writes, mask


# --------------------------------------------------------------------
# the kernel's warp phases in numpy, for the tests

LANES = 32


def run_positions(ip: int, miss: int, accel_log: int, limit: int):
    """The positions the lanes of one dual-arm miss run take (the serial
    walk's next 32 probes if every one of them missed: a prefix sum of
    1 + (miss >> accel_log)), the step after each, and which lie below
    the probe limit."""
    d = 1 + ((miss + np.arange(LANES)) >> accel_log)
    p = ip + np.cumsum(d) - d
    return p, d, p < limit


def lane_hashes(win: np.ndarray, p: np.ndarray, strict: bool, dual: bool,
                clamped: bool = False):
    """What a lane computes at window position p, from the window's words
    as the kernel loads them (unclamped at probes, which stay 12 bytes
    before the block end; clamped for a match's inserts): the 8 bytes w
    and ext4, then ((bucket, tagb) of the one table or the dual short
    half, (bucket, tagb) of the long quarter or None)."""
    words = win.view("<u4")
    WW = len(words)
    p = np.asarray(p, np.int64)
    q = p >> 2
    sh = ((p & 3) * 8).astype(np.uint32)
    top = WW - 1 if clamped else WW + 1
    lo = words[q]
    hi = words[np.minimum(q + 1, top)]
    w3 = words[np.minimum(q + 2, top)]
    nz = (np.uint32(32) - sh) & np.uint32(31)
    w = np.where(sh == 0, lo, (lo >> sh) | (hi << nz))
    ext4 = np.where(sh == 0, hi, (hi >> sh) | (w3 << nz))
    ext = (ext4 & np.uint32(0xFF)) if dual or not strict else ext4
    u = (w ^ (ext * _GOLD)) * _PRIME if strict else \
        (w ^ (ext << np.uint32(13))) * _PRIME
    main = _bucket_tag(u, HASH_LOG - 1 if dual else HASH_LOG, 0)
    if not dual:
        return w, ext4, main, None
    return w, ext4, main, _bucket_tag((w ^ (ext4 * _GOLD)) * _PRIME,
                                      HASH_LOG - 2, 1 << (HASH_LOG - 1))


def miss_run(table: list, win: np.ndarray, st: list, *, base: int,
             min_abs: int, limit: int, strict: bool, accel_log: int,
             rep_probe: bool, cap: int = CAP):
    """One dual-arm miss run (run_dual in csrc/parse_linked.cu) on a
    table list and the walk state st = [ip, anchor, cnt, miss, rep].
    Each lane probes its position: the repcode check, then both
    sub-tables, reading a bucket from the table unless an earlier lane
    seeds the same bucket, whose value it takes instead.  The first lane
    that hits ends the run; the lanes up to it seed the table, the
    highest lane of a bucket winning.  Returns (h, ip, miss, cand_abs,
    short4): the hit lane (32 if none), the walk's next position and
    miss count, and with a hit its candidate and whether it came from
    the short half alone."""
    ip, _, cnt, miss, rep = st
    p, d, valid = run_positions(ip, miss, accel_log, limit)
    wb = win.tobytes()
    pv = np.where(valid, p, ip)
    _, _, (hs, ts), (hl, tl) = lane_hashes(win, pv, strict, True)
    hits, cands = [], []
    for j in range(LANES):
        if not valid[j]:
            hits.append(False)
            cands.append(None)
            continue
        pj = int(p[j])
        pos = base + pj
        wlo = max(min_abs, pos - MAX_OFFSET)
        c = max(pj - rep, 0)
        rep_hit = rep_probe and rep > 0 and cnt < cap and \
            wb[c: c + 4] == wb[pj: pj + 4]
        ent = []
        for h, tb in ((hs, ts), (hl, tl)):
            prev = [i for i in range(j) if valid[i] and h[i] == h[j]]
            ent.append(base + int(p[prev[-1]]) | tb[prev[-1]] if prev
                       else table[h[j]])
        good_s = ts[j] + wlo <= ent[0] < ts[j] + pos
        good_l = tl[j] + wlo <= ent[1] < tl[j] + pos
        hits.append(rep_hit or ((good_l or good_s) and cnt < cap))
        cands.append((pos - rep, False) if rep_hit else
                     ((ent[1] if good_l else ent[0]) & 0xFFFFFF, not good_l))
    h = hits.index(True) if True in hits else LANES
    done = [j for j in range(min(h + 1, LANES)) if valid[j]]
    for j in done:
        for b, tb in ((hs, ts), (hl, tl)):
            if not any(b[i] == b[j] for i in done if i > j):
                table[b[j]] = base + int(p[j]) | tb[j]
    if h == LANES:
        n = int(valid.sum())
        return h, int(p[n - 1] + d[n - 1]), miss + n, None, None
    return (h, int(p[h]), miss + h) + cands[h]


def lane_extend(win: np.ndarray, ip: int, cand: int, lim: int) -> int:
    """extend's warp form: 4 plus the common prefix of ip+4.. and
    cand+4.., capped at lim, found 32 words (128 bytes) a step: each lane
    counts the bytes of its word that match below lim, and the first lane
    short of 4 ends the extension."""
    wb = win.tobytes()
    l = 4
    while True:
        ks = []
        for lane in range(LANES):
            a, b = ip + l + 4 * lane, cand + l + 4 * lane
            k = 0
            if a < lim:
                while k < 4 and wb[a + k] == wb[b + k]:
                    k += 1
                k = min(k, lim - a)
            ks.append(k)
        short = [i for i, k in enumerate(ks) if k < 4]
        if not short:
            l += 4 * LANES
            continue
        return l + 4 * short[0] + ks[short[0]]


def lane_back_extend(win: np.ndarray, ip: int, cand: int, anchor: int,
                     minw: int) -> int:
    """The backward extension's warp form: lane t tests byte kb + t
    before ip against the one before cand, 32 a step; the first lane that
    fails gives the count."""
    wb = win.tobytes()
    kb = 0
    while True:
        for t in range(LANES):
            j = kb + t
            if not (ip - j > anchor and cand - j > minw and
                    wb[ip - j - 1] == wb[max(cand - j - 1, 0)]):
                return j
        kb += LANES
