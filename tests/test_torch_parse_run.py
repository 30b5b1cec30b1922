"""K1's warp walk, its phases: a dual-arm miss run (32 positions probed
at once, buckets an earlier lane seeds forwarded to the later lanes, the
table seeded by the highest lane of each bucket) and the 32-word extend
and 32-byte backward extension (ops/parse_linked.miss_run, lane_extend,
lane_back_extend, mirrors of csrc/parse_linked.cu), against the serial
walk's steps written out here as the plain walk takes them.  Integers:
tolerance none."""

import numpy as np

from libzseek_tpu_torch.ops.parse_linked import (CAP, TAB_SIZE,
                                                 MAX_OFFSET, _row_hashes,
                                                 lane_back_extend,
                                                 lane_extend, miss_run)

N = 4096


def _window(seed, vocab):
    rng = np.random.default_rng(seed)
    win = rng.choice(np.frombuffer(vocab, np.uint8), 2 * N).astype(np.uint8)
    win[N + 700: N + 1100] = win[N + 100: N + 500]
    win[N + 2000: N + 2064] = win[N + 1900: N + 1964]
    return win


def _serial_run(table, win, st, base, min_abs, limit, strict, accel,
                rep_probe, cap):
    """body1_dual's probes one position at a time, up to 32 of them or
    the first hit: (h, ip, miss, cand_abs, short4)."""
    (H, T), (HL, TL) = _row_hashes(win, strict, True)
    wb = win.tobytes()
    ip, _, cnt, miss, rep = st
    for j in range(32):
        if ip >= limit:
            return 32, ip, miss, None, None
        pos = base + ip
        wlo = max(min_abs, pos - MAX_OFFSET)
        c = max(ip - rep, 0)
        rep_hit = rep_probe and rep > 0 and cnt < cap and \
            wb[c: c + 4] == wb[ip: ip + 4]
        es, el = table[H[ip]], table[HL[ip]]
        good_l = TL[ip] + wlo <= el < TL[ip] + pos
        good_s = T[ip] + wlo <= es < T[ip] + pos
        table[H[ip]] = pos | T[ip]
        table[HL[ip]] = pos | TL[ip]
        if rep_hit:
            return j, ip, miss, pos - rep, False
        if (good_l or good_s) and cnt < cap:
            return j, ip, miss, (el if good_l else es) & 0xFFFFFF, not good_l
        ip += 1 + (miss >> accel)
        miss += 1
    return 32, ip, miss, None, None


def test_miss_run_matches_serial_probes():
    """Runs from many walk states, on strict and non-strict rows of text
    with repeats (buckets recur inside a run), with the repcode probe on
    and off, a full sequence budget (no hit can be taken) and runs cut by
    the probe limit: the hit lane, the next position and miss count, the
    candidate and the whole table equal the serial walk's."""
    base, min_abs = 5 * N, 5 * N
    limit = 2 * N - 12
    hits = 0
    for seed, vocab in ((1, b"abcab cab"), (2, b"the cat sat on a mat. "),
                        (3, bytes(range(256)))):
        win = _window(seed, vocab)
        rng = np.random.default_rng(seed)
        for strict in (True, False):
            table = [-1] * TAB_SIZE
            st = [N, N, 0, 0, 0]
            for _ in range(120):
                ip = int(rng.integers(N, limit))
                miss = int(rng.integers(0, 3000))
                rep = int(rng.choice([0, 64, 100, 600]))
                cnt = int(rng.choice([0, 5, CAP]))
                st = [ip, N, cnt, miss, rep]
                for accel, rep_probe in ((8, True), (10, False), (5, True)):
                    t_ser, t_run = list(table), list(table)
                    a = _serial_run(t_ser, win, st, base, min_abs, limit,
                                    strict, accel, rep_probe, CAP)
                    b = miss_run(t_run, win, st, base=base, min_abs=min_abs,
                                 limit=limit, strict=strict, accel_log=accel,
                                 rep_probe=rep_probe)
                    assert a == b, (st, accel, rep_probe)
                    assert t_ser == t_run
                    table = t_run
                    hits += a[0] < 32
    assert hits > 100


def _serial_extend(wb, ip, cand, lim):
    l = 4
    while ip + l + 64 <= lim and \
            wb[ip + l: ip + l + 64] == wb[cand + l: cand + l + 64]:
        l += 64
    while ip + l + 4 <= lim and wb[ip + l: ip + l + 4] == \
            wb[cand + l: cand + l + 4]:
        l += 4
    for _ in range(3):
        if ip + l < lim and wb[ip + l] == wb[cand + l]:
            l += 1
        else:
            break
    return l


def _serial_back(wb, ip, cand, anchor, minw):
    kb = 0
    while ip - kb > anchor and cand - kb > minw and \
            wb[ip - kb - 1] == wb[max(cand - kb - 1, 0)]:
        kb += 1
    return kb


def test_warp_extensions_match_serial():
    """Forward extensions of every length (short, past one and several
    32-word steps, up to the block end, unconfirmed candidates) and
    backward extensions stopped by a byte, the anchor or the window's low
    fence."""
    rng = np.random.default_rng(9)
    win = rng.integers(0, 4, 2 * N, np.uint8)
    win[N + 1000: N + 3000] = win[N - 700: N + 1300]
    win[2 * N - 400:] = win[2 * N - 800: 2 * N - 400]
    wb = win.tobytes()
    for ip, cand in ((N + 1000, N - 700), (N + 1100, N - 600),
                     (2 * N - 400, 2 * N - 800), (2 * N - 300, 2 * N - 700),
                     (N + 5, N + 1), (N + 2999, N + 1299)):
        for lim in (2 * N, 2 * N - 37, N + 3050):
            if ip + 13 > lim:
                continue
            assert lane_extend(win, ip, cand, lim) == \
                _serial_extend(wb, ip, cand, lim)
    for _ in range(300):
        ip = int(rng.integers(N, 2 * N - 16))
        cand = int(rng.integers(0, ip))
        lim = int(rng.integers(ip + 13, 2 * N + 1))
        assert lane_extend(win, ip, cand, lim) == \
            _serial_extend(wb, ip, cand, lim)
        anchor = int(rng.integers(N - 200, ip + 1))
        minw = int(rng.integers(0, max(1, cand)))
        assert lane_back_extend(win, ip, cand, anchor, minw) == \
            _serial_back(wb, ip, cand, anchor, minw)
    assert lane_back_extend(win, N + 1500, N - 200, N, 0) == \
        _serial_back(wb, N + 1500, N - 200, N, 0) == 500
