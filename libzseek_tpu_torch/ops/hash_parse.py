"""K7: per-block zstd-fast hash parse.

Counterpart of libzseek_tpu/ops/pallas_match.py hash_parse_blocks_smem
(:122), which runs the Pallas kernel _parse_kernel_smem (:37, the
pallas_call at :154).  The CUDA kernel is csrc/hash_parse.cu; the plain
version below is the same walk in Python ints and runs only for tensors
on the CPU.

Every decision that changes the sequences is the reference's: a
2^16-entry table of positions reset to -1 for every row, the hash
(w * 2654435761) >> 16 of the 4 bytes at ip, the table store before the
candidate test, the test cand >= 0, ip - cand <= max_offset, a free
sequence slot and equal 4 bytes at max(cand, 0), the extension a word at
a time while ip + l + 4 <= blen and then up to 3 bytes, the miss step
1 + (miss >> 6), and the end of probing at blen - 12.  Outputs: ll, ml,
offv = offset + 3, n_seq and cover_end (the last anchor).

Only the zstd arm is ported (start_ip = 0, end_margin = 0, min_ref = 0).
The reference's seeded arm (a context prefix, LZ4's 5-byte end margin)
serves only lz4_encode.lz4_encode_blocks_fast, which has no caller; it is
retired in the port (ROADMAP A11) and asking for it raises.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError

HASH_LOG = 16
MAX_OFFSET = (1 << 17) - 1
MAX_BLOCK = 1 << 17     # positions + 1 fit the CUDA table's 17 bits

_PRIME = np.uint32(2654435761)

launches = 0
_count = threading.Lock()


def default_cap(n: int) -> int:
    """Sequence slots per row: max(128, N / 8), the reference's default."""
    return max(128, n // 8)


def hash_parse(x: torch.Tensor, lengths: torch.Tensor, *,
               start_ip: int = 0, end_margin: int = 0, min_ref=None):
    """x (B, N) uint8 block rows (N a multiple of 4), lengths (B,) int32.
    Returns (ll, ml, offv) (B, default_cap(N)) int32, zero past each
    row's n_seq, and n_seq, cover_end (B,) int32; offsets reach at most
    MAX_OFFSET back."""
    if start_ip or end_margin or min_ref is not None:
        raise ParameterError(
            "K7: the seeded arm (start_ip, end_margin, min_ref) serves only "
            "the LZ4 path's lz4_encode_blocks_fast, which the port retires "
            "(ROADMAP A11)")
    B, N = x.shape
    if x.dtype != torch.uint8 or N % 4 or not 16 <= N <= MAX_BLOCK:
        raise ParameterError(f"K7: x must be (B, N) uint8 with N % 4 == 0 "
                             f"and 16 <= N <= {MAX_BLOCK}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != x.device:
        raise ParameterError(f"K7: lengths must be ({B},) int32 on "
                             f"{x.device}")
    cap = default_cap(N)
    if x.device.type == "cpu":
        return _parse_plain(x.numpy(), lengths.numpy(), cap)
    if x.device.type != "cuda":
        raise ParameterError(f"K7 runs on cuda or cpu tensors, not "
                             f"{x.device}")
    return _parse_cuda(x, lengths, cap)


def _parse_cuda(x, lengths, cap):
    """One CUDA block per row; the rows are independent."""
    global launches
    from libzseek_tpu_torch import kernels
    dev = x.device
    B, N = x.shape
    x = x.contiguous()
    if x.data_ptr() % 4:
        raise ParameterError("K7: x must start on a 4-byte boundary")
    ll = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    ml = torch.zeros_like(ll)
    offv = torch.zeros_like(ll)
    nn = torch.empty((B, 2), dtype=torch.int32, device=dev)
    kernels.launch(
        "zk_hash_parse", dev, x.data_ptr(), lengths.contiguous().data_ptr(), B,
        N, cap, MAX_OFFSET, ll.data_ptr(), ml.data_ptr(), offv.data_ptr(),
        nn.data_ptr())
    with _count:
        launches += 1
    return ll, ml, offv, nn[:, 0], nn[:, 1]


# --------------------------------------------------------------------
# plain version: the same walk in Python ints


def _words_and_hashes(row: np.ndarray):
    """The 4 bytes at every position p <= N - 4 (little-endian) and their
    hashes, as Python lists."""
    r = row.astype(np.uint32)
    w = r[:-3] | (r[1:-2] << 8) | (r[2:-1] << 16) | (r[3:] << 24)
    h = (w * _PRIME) >> np.uint32(32 - HASH_LOG)
    return w.tolist(), h.tolist()


def _parse_row(row: np.ndarray, blen: int, cap: int):
    """(ll, ml, offv lists, n_seq, cover_end) of one row."""
    W, H = _words_and_hashes(row)
    xb = row.tobytes()
    table = [-1] * (1 << HASH_LOG)
    ll, ml, off = [], [], []
    ip = anchor = miss = 0
    limit = blen - 12
    while ip < limit:
        w = W[ip]
        h = H[ip]
        cand = table[h]
        table[h] = ip
        if cand >= 0 and ip - cand <= MAX_OFFSET and len(ll) < cap and \
                W[cand] == w:
            # 4 + the common prefix past the first word, capped at blen
            room = blen - ip - 4
            a, b, m = ip + 4, cand + 4, 0
            while m + 64 <= room and xb[a + m: a + m + 64] == \
                    xb[b + m: b + m + 64]:
                m += 64
            while m < room and xb[a + m] == xb[b + m]:
                m += 1
            ll.append(ip - anchor)
            ml.append(4 + m)
            off.append(ip - cand + 3)
            ip += 4 + m
            anchor = ip
            miss = 0
        else:
            ip += 1 + (miss >> 6)
            miss += 1
    return ll, ml, off, len(ll), anchor


def _parse_plain(xs, lens, cap):
    B = xs.shape[0]
    out = np.zeros((3, B, cap), np.int32)
    nn = np.zeros((2, B), np.int32)
    for r in range(B):
        ll, ml, off, n, cover = _parse_row(xs[r], int(lens[r]), cap)
        out[0, r, :n], out[1, r, :n], out[2, r, :n] = ll, ml, off
        nn[:, r] = n, cover
    t = torch.from_numpy
    return t(out[0]), t(out[1]), t(out[2]), t(nn[0]), t(nn[1])


# --------------------------------------------------------------------
# the CUDA kernel's rounds, mirrored in Python ints (used only by tests)

LANES = 32
DENSE_MISS = 32     # a round starting at miss <= 32 steps by 1 throughout
EXT_WORDS = 2       # words past the first that a lane compares on its own


def miss_skip(n: int) -> int:
    """sum(i >> 6 for i < n): the extra steps of the first n misses."""
    q, r = n >> 6, n & 63
    return 32 * q * (q - 1) + q * r


def lane_length(W, pos: int, cand: int):
    """A lane's own extension of a confirmed 4-byte match: (length, long).
    It compares the EXT_WORDS words past the first (inside the row for
    every probed position: pos + 4 + 4 * EXT_WORDS <= blen - 1), the
    first unequal one ending the match at its first unequal byte (the
    xor's lowest set byte).  long: both equal, the length is at least
    4 + 4 * EXT_WORDS and the warp extends it."""
    q = 4
    for _ in range(EXT_WORDS):
        x = W[pos + q] ^ W[cand + q]
        if x:
            return q + ((x & -x).bit_length() - 1) // 8, False
        q += 4
    return q, True


def warp_length(xb: bytes, W, blen: int, pos: int, cand: int,
                l: int) -> int:
    """The warp's extension from l (32 words a step, as a ballot finds the
    first unequal one), then the first unequal word's xor, or bytes at
    the row's end."""
    R = blen - pos
    while l + 4 <= R and W[pos + l] == W[cand + l]:
        l += 4
    if l + 4 <= R:
        x = W[pos + l] ^ W[cand + l]
        return l + ((x & -x).bit_length() - 1) // 8
    while l < R and xb[pos + l] == xb[cand + l]:
        l += 1
    return l


def parse_rounds(row: np.ndarray, blen: int, cap: int):
    """K7's walk as the CUDA kernel takes it, a round of 32 positions at a
    time: (ll, ml, offv lists, n_seq, cover_end, stats).

    Lane k of a round takes the walk's k-th next position if every one
    before it misses (ip + k, or with the miss accelerator's steps when
    the round starts past DENSE_MISS misses) and tests it against the
    table as it stood at the round's start, or, where an earlier lane of
    the round has the same hash, against that lane's position (the table
    holds the last position probed in each bucket).  The walk over the
    lanes (the kernel finds it by pointer doubling; here it is followed
    lane by lane) goes after a miss to the next lane, after a hit of
    length l to the lane l further on (dense rounds only; a round past
    DENSE_MISS misses ends at its first hit).  The round is cut before
    the first lane whose forwarded lane the walk skipped (its candidate
    is then older), and before a hit past `cap`.  The probed lanes
    write the table, the last of each bucket winning."""
    W, H = _words_and_hashes(row)
    xb = row.tobytes()
    table = [-1] * (1 << HASH_LOG)
    ll, ml, off = [], [], []
    ip = anchor = miss = 0
    limit = blen - 12
    stats = dict(rounds=0, dense=0, cut_forward=0, cut_cap=0, long=0)
    while ip < limit:
        stats["rounds"] += 1
        dense = miss <= DENSE_MISS
        stats["dense"] += dense
        cnt = len(ll)
        lanes = []
        for k in range(LANES):
            pos = ip + k + miss_skip(miss + k) - miss_skip(miss)
            if pos >= limit:
                break
            h = H[pos]
            prior = [j for j in range(k) if lanes[j]["h"] == h]
            jd = prior[-1] if prior else -1
            cand = lanes[jd]["pos"] if jd >= 0 else table[h]
            hit = cnt < cap and cand >= 0 and pos - cand <= MAX_OFFSET \
                and W[cand] == W[pos]
            ln, lg = lane_length(W, pos, cand) if hit else (0, 0)
            lanes.append(dict(pos=pos, h=h, jd=jd, cand=cand, hit=hit,
                              len=ln, long=lg))
        n = len(lanes)
        ip0, m0 = ip, miss
        posf = lambda k: ip0 + k + miss_skip(m0 + k) - miss_skip(m0)
        # the walk over the lanes
        path, cur = [], 0
        while cur < n:
            path.append(cur)
            L = lanes[cur]
            if not L["hit"]:
                cur += 1
            elif L["long"] or not dense:
                break
            else:
                cur += L["len"]
        # cuts: before a lane whose forwarding lane the walk skipped, then
        # before a hit past cap; the round's next position is the cut lane's
        stop = None
        on = set(path)
        for i, k in enumerate(path):
            if lanes[k]["jd"] >= 0 and lanes[k]["jd"] not in on:
                stop, path = k, path[:i]
                stats["cut_forward"] += 1
                break
        hits = [k for k in path if lanes[k]["hit"]]
        if cnt + len(hits) > cap:
            stop = hits[cap - cnt]
            path = path[: path.index(stop)]
            stats["cut_cap"] += 1
        for k in path:
            L = lanes[k]
            table[L["h"]] = L["pos"]
            if not L["hit"]:
                miss += 1
                continue
            if L["long"]:
                stats["long"] += 1
                L["len"] = warp_length(xb, W, blen, L["pos"], L["cand"],
                                       L["len"])
            ll.append(L["pos"] - anchor)
            ml.append(L["len"])
            off.append(L["pos"] - L["cand"] + 3)
            anchor = L["pos"] + L["len"]
        last = lanes[path[-1]]
        if stop is not None:
            nxt = lanes[stop]["pos"]
        elif last["hit"]:
            nxt = last["pos"] + last["len"]
        else:
            nxt = posf(path[-1] + 1)
        if any(lanes[k]["hit"] for k in path):
            last_hit = max(k for k in path if lanes[k]["hit"])
            miss = sum(1 for k in path if k > last_hit)
        ip = nxt
    return ll, ml, off, len(ll), anchor, stats
