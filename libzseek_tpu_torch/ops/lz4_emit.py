"""K5: fused LZ4 block encode (hash-probe parse with inline emission).

Counterpart of libzseek_tpu/ops/pallas_lz4.py lz4_emit_blocks_smem
(:355), which runs the Pallas kernel _lz4_kernel (:41, the pallas_call at
:390), and of lz4_compress_bound (libzseek_tpu/ops/lz4_encode.py:27).
The CUDA kernel is csrc/lz4_emit.cu; the plain version below is the same
walk in Python ints and runs only for tensors on the CPU.

Every decision that changes the bytes is the reference's: the tagged
hash table {tag:7, pos:24} over absolute positions row * N + p, the
window fences (min_ref, max_offset, the quad loop's bound 3 bytes
short), the miss skip miss >> (accel_log + 2) of the quad loop and
miss >> accel_log of the single step, the lazy arm, the insert at the
match tail, and liblz4's end rules (probes stop at blen - 12, the last
5 bytes stay literals).

The reference keeps one table for the whole grid, reset and seeded from
row 0 at grid step 0.  Both versions here walk one chain of rows per
frame (a chain starts where min_ref fences off the previous row,
ops/parse_linked.chain_bounds) with a fresh table: an entry written
before the fence fails the window check exactly like an empty slot.
The chain that starts at row 0 is first seeded from row 0, as the
reference's step 0 is, which matters when row 0 is the previous block
of a frame the batch continues.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.ops.parse_linked import chain_bounds

HASH_LOG = 16
TAB_SIZE = 1 << HASH_LOG
MAX_OFFSET = 65535
BLOCK = 1 << 16

_PRIME = np.uint32(2654435761)
_TAG_MASK = 0x7F << 24

launches = 0
_count = threading.Lock()


def lz4_compress_bound(n: int) -> int:
    """Worst-case encoded size of one block (mirrors LZ4_compressBound)."""
    return n + n // 255 + 16


def out_cap(block: int = BLOCK) -> int:
    """Output row size: the compress bound rounded up to 128 bytes."""
    cap = lz4_compress_bound(block)
    return cap + (-cap) % 128


def lz4_emit(blocks: torch.Tensor, lengths: torch.Tensor,
             min_ref: torch.Tensor, cap: int, *, lazy: int = 0,
             accel_log: int = 6):
    """blocks (B+1, N) uint8: row r+1 is block r and row r its context;
    lengths (B,) int32 = N + block r's size; min_ref (B,) int32, the first
    referenceable absolute position (block r's bytes start at (r+1) * N).
    Returns (out (B, cap) uint8, zero past each row's payload, olen (B,)
    int32)."""
    B1, N = blocks.shape
    B = B1 - 1
    if blocks.dtype != torch.uint8 or N % 4 or B < 1:
        raise ParameterError("K5: blocks must be (B+1, N) uint8, N % 4 == 0")
    if B1 * N > (1 << 24):
        raise ParameterError("K5: batch too large for tagged-table positions")
    if cap % 4 or cap < lz4_compress_bound(N):
        raise ParameterError(f"K5: cap {cap} below the compress bound")
    for name, t in (("lengths", lengths), ("min_ref", min_ref)):
        if t.shape != (B,) or t.dtype != torch.int32 or \
                t.device != blocks.device:
            raise ParameterError(f"K5: {name} must be ({B},) int32 on "
                                 f"{blocks.device}")
    if blocks.device.type == "cpu":
        mr = min_ref.numpy()
        if (mr < np.arange(B) * N).any():
            raise ParameterError("K5: min_ref must not reach before the "
                                 "previous row")
        return _emit_plain(blocks.numpy(), lengths.numpy(), mr,
                           chain_bounds(mr, N), cap, lazy, accel_log)
    if blocks.device.type != "cuda":
        raise ParameterError(f"K5 runs on cuda or cpu tensors, not "
                             f"{blocks.device}")
    return _emit_cuda(blocks, lengths, min_ref, cap, lazy, accel_log)


def _emit_cuda(blocks, lengths, min_ref, cap, lazy, accel_log):
    """One CUDA block per row; the blocks of chain-start rows walk their
    chains (the kernel finds them from min_ref, so no host sync)."""
    global launches
    from libzseek_tpu_torch import kernels
    dev = blocks.device
    B1, N = blocks.shape
    B = B1 - 1
    blocks = blocks.contiguous()
    if blocks.data_ptr() % 4:
        raise ParameterError("K5: blocks must start on a 4-byte boundary")
    tables = torch.empty((B, TAB_SIZE), dtype=torch.int32, device=dev)
    out = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    olen = torch.empty((B,), dtype=torch.int32, device=dev)
    kernels.launch(
        "zk_lz4_emit", dev, blocks.data_ptr(), lengths.contiguous().data_ptr(),
        min_ref.contiguous().data_ptr(), B, N, cap, MAX_OFFSET, lazy,
        accel_log, tables.data_ptr(), out.data_ptr(), olen.data_ptr())
    with _count:
        launches += 1
    return out, olen


# --------------------------------------------------------------------
# plain version: the same walk in Python ints


def _window_hashes(win: np.ndarray):
    """(word, bucket, tagb) at every window position, with the
    reference's clamped loads (past the end the last word repeats)."""
    words = win.view("<u4")
    WW = len(words)
    p = np.arange(4 * WW)
    q = p >> 2
    sh = ((p & 3) * 8).astype(np.uint32)
    lo = words[q]
    hi = words[np.minimum(q + 1, WW - 1)]
    w = np.where(sh == 0, lo, (lo >> sh) | (hi << ((32 - sh) & 31)))
    u = w * _PRIME
    h = (u >> np.uint32(32 - HASH_LOG)).astype(np.int64)
    tagb = ((u << np.uint32(HASH_LOG - 1)) & np.uint32(_TAG_MASK)) \
        .astype(np.int64)
    return w.tolist(), h, tagb


def _seed(table: list, h: np.ndarray, tagb: np.ndarray, n: int) -> None:
    """Insert positions [0, n) in order (base 0): the last write to a
    bucket wins."""
    rev = h[:n][::-1]
    buckets, first = np.unique(rev, return_index=True)
    last = (n - 1) - first
    for b, p in zip(buckets.tolist(), last.tolist()):
        table[b] = p | int(tagb[p])


def _emit_plain(xs, lens, mr, bounds, cap, lazy, accel_log):
    B1, N = xs.shape
    B = B1 - 1
    out = np.zeros((B, cap), np.uint8)
    olen = np.zeros(B, np.int32)
    bounds = bounds.tolist()
    for c in range(len(bounds) - 1):
        table = [-1] * TAB_SIZE
        for r in range(bounds[c], bounds[c + 1]):
            win = xs[r: r + 2].reshape(-1)
            W, h, tagb = _window_hashes(win)
            if r == 0:
                _seed(table, h, tagb, N - 3)
            payload = _emit_row(win.tobytes(), W, h.tolist(), tagb.tolist(),
                                table, N, int(lens[r]), r * N, int(mr[r]),
                                lazy, accel_log)
            out[r, : len(payload)] = np.frombuffer(payload, np.uint8)
            olen[r] = len(payload)
    return torch.from_numpy(out), torch.from_numpy(olen)


def _emit_row(wb, W, H, T, table, N, blen, base, min_ref, lazy, accel_log):
    limit = blen - 12
    lit_limit = blen - 5
    out = bytearray()

    def insert_at(p):
        table[H[p]] = (base + p) | T[p]

    def extend(ip, cand):
        # 4 + the common prefix past the first word, capped at lit_limit
        room = lit_limit - ip - 4
        a, b, m = ip + 4, cand + 4, 0
        while m + 64 <= room and wb[a + m: a + m + 64] == \
                wb[b + m: b + m + 64]:
            m += 64
        while m < room and wb[a + m] == wb[b + m]:
            m += 1
        return 4 + m

    def emit_len_ext(v):
        while v >= 255:
            out.append(255)
            v -= 255
        out.append(v)

    def emit_seq(anchor, ip, mlen, dist):
        litlen = ip - anchor
        out.append((min(litlen, 15) << 4) | min(mlen - 4, 15))
        if litlen >= 15:
            emit_len_ext(litlen - 15)
        out.extend(wb[anchor: ip])
        out.append(dist & 0xFF)
        out.append(dist >> 8)
        if mlen - 4 >= 15:
            emit_len_ext(mlen - 19)

    def match_at(st, ip, cand_abs):
        _, anchor, miss = st
        cand = cand_abs - base
        if W[cand] != W[ip]:                      # tag collision
            return [ip + 1 + (miss >> accel_log), anchor, miss + 1]
        lf = extend(ip, cand)
        ipf, candf = ip, cand
        for _ in range(lazy):
            if ipf + 1 >= limit:
                continue
            p2 = ipf + 1
            h2, tb2 = H[p2], T[p2]
            e2 = table[h2]
            pos2 = base + p2
            wlo2 = max(min_ref, pos2 - MAX_OFFSET)
            table[h2] = pos2 | tb2
            if tb2 + wlo2 <= e2 < tb2 + pos2:
                c2 = (e2 & 0xFFFFFF) - base
                if W[c2] == W[p2]:
                    l2 = extend(p2, c2)
                    if l2 > lf:
                        ipf, candf, lf = p2, c2, l2
        emit_seq(anchor, ipf, lf, ipf - candf)
        insert_at(ipf + lf - 2)
        return [ipf + lf, ipf + lf, 0]

    def body1(st):
        ip, anchor, miss = st
        pos = base + ip
        wlo = max(min_ref, pos - MAX_OFFSET)
        h, tb = H[ip], T[ip]
        e = table[h]
        table[h] = pos | tb
        if tb + wlo <= e < tb + pos:
            return match_at(st, ip, e & 0xFFFFFF)
        return [ip + 1 + (miss >> accel_log), anchor, miss + 1]

    qlim = blen - 16
    qshift = accel_log + 2
    st = [N, N, 0]
    while st[0] < limit:
        while st[0] < limit and st[0] & 3:
            st = body1(st)
        q = st[0] >> 2
        qp = q
        fnd = 0
        miss = st[2]
        es = None
        while fnd == 0 and 4 * q <= qlim:
            p = 4 * q
            pos0 = base + p
            wlo = max(min_ref, pos0 - (MAX_OFFSET - 3))
            es = []
            for k in range(4):
                h, tb = H[p + k], T[p + k]
                e = table[h]
                table[h] = (pos0 + k) | tb
                if tb + wlo <= e < tb + pos0 + k:
                    fnd |= 1 << k
                es.append(e)
            qp = q
            q = q + 1 + (miss >> qshift)
            miss += 4
        st[2] = miss
        if fnd:
            k = (fnd & -fnd).bit_length() - 1
            st = match_at(st, 4 * qp + k, es[k] & 0xFFFFFF)
        else:
            st[0] = 4 * q
            while st[0] < limit:
                st = body1(st)
    anchor = st[1]
    litlen = blen - anchor
    out.append(min(litlen, 15) << 4)
    if litlen >= 15:
        emit_len_ext(litlen - 15)
    out.extend(wb[anchor: blen])
    return bytes(out)
