"""Per-block Huffman table construction and literal-mode planning.

Counterpart of libzseek_tpu/ops/huffman_plan.py: assign_kraft (:53),
canonical_from_kraft (:206), pack_weights (:231), unpack_weights (:240),
plan_blocks (:250) and the M_* literal-section mode codes (:39-45).

Code lengths come from a Kraft-exact assignment: power-of-two budgets
rounded from the scaled histogram, bulk grow rounds by a thresholded
bits-per-budget priority, then single moves until each row's budget sums
to 2^11, with a balanced-code fallback.  Every float32 operation here is
a division, a halving or a sum of integers below 2^24, so the results do
not depend on the device or the summation order.

The torch functions are the CPU path.  On a CUDA device the chain takes
plan_all_cuda: this plan and ops/fse_plan.py plan_seq_tables in one
launch of csrc/plan.cu, equal to them array for array, with no host sync;
testing/plan_mirror.py mirrors the kernel's phases in numpy.
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from libzseek_tpu_torch.ops.common import u32_to_i32

MAX_BITS = 11
TAB = 1 << MAX_BITS

M_SKIP = 0      # block certain to be stored raw: no streams at all
M_RLEBLOCK = 1  # whole block is one repeated byte -> RLE block
M_NONE = 2      # no literals
M_RLE = 3       # single literal byte value -> RLE literal section
M_RAW = 4       # raw literal bytes
M_HUF = 5       # 4-stream Huffman literals
M_HUF1 = 6      # 1-stream Huffman literals (literal set < 256 bytes)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x, 1))) for int tensors below 2^24 (exact through
    the float32 exponent)."""
    _, e = torch.frexp(torch.clamp(x, min=1).to(torch.float32))
    return (e - 1).to(torch.int32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(e) << e


def assign_kraft(hist: torch.Tensor) -> torch.Tensor:
    """(B, 256) counts -> per-symbol Kraft budgets (B, 256) int32: powers
    of two in [1, 1024] for used symbols, summing to 2048 per row (code
    length = 11 - log2(k)).  Rows with < 2 used symbols get 0."""
    hist = hist.to(torch.int32)
    used = hist > 0
    m = used.sum(1)
    total = hist.sum(1, keepdim=True).to(torch.int32)
    multi = (m >= 2)[:, None]
    scaled = torch.clamp(hist * TAB // torch.clamp(total, min=1), min=1)
    k0 = torch.clamp(_pow2(torch.clamp(floor_log2(scaled), 0, 10)),
                     1, 1 << 10)
    zero = torch.zeros_like(hist)
    k = torch.where(used & multi, k0, zero)
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=hist.device)
    big = torch.tensor(1e30, dtype=torch.float32, device=hist.device)
    f0 = torch.zeros((), dtype=torch.float32, device=hist.device)
    histf = hist.to(torch.float32)

    # bulk grow rounds: accept every doubling whose bits-saved per budget
    # unit clears a per-row threshold, found by a 24-step bisection so
    # the accepted cost fits the remaining deficit
    for _ in range(8):
        D = torch.clamp(TAB - k.sum(1), min=0).to(torch.float32)
        kf = torch.clamp(k, min=1).to(torch.float32)
        elig = (k > 0) & (k < (1 << 10))
        prio = torch.where(elig, histf / kf, neg_inf)
        cost = torch.where(elig, k, zero).to(torch.float32)
        hi = torch.where(elig, prio, f0).amax(1) + 1.0
        lo = torch.zeros_like(hi)
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            c = torch.where(prio >= mid[:, None], cost, f0).sum(1)
            ok = c <= D
            lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
        accept = elig & (prio >= hi[:, None])
        k = torch.where(accept, k * 2, k)

    # single moves until every row's budget is exact (at most 64)
    for _ in range(64):
        K = k.sum(1)
        npos = (k > 0).sum(1)
        need = (K != TAB) & (npos >= 2)
        if not bool(need.any()):
            break
        D = TAB - K
        kf = torch.clamp(k, min=1).to(torch.float32)
        jg = torch.clamp(floor_log2(torch.clamp(D, min=1)), 0, 10)
        elig_g = (k > 0) & (k <= _pow2(jg)[:, None]) & (k < (1 << 10))
        pick_g = torch.where(elig_g, histf / kf, neg_inf).argmax(1)
        ok_g = elig_g.any(1)
        js = torch.clamp(floor_log2(torch.clamp(-D, min=1)), 0, 10)
        elig_s = (k >= 2) & (k <= (2 * _pow2(js))[:, None])
        pick_s = torch.where(elig_s, histf / kf, big).argmin(1)
        ok_s = elig_s.any(1)
        elig_p = (k > 0) & (k < (1 << 10))
        pick_p = torch.where(elig_p, k, torch.full_like(k, 1 << 30)) \
            .argmin(1)
        grow = D > 0
        pick = torch.where(grow, pick_g, torch.where(ok_s, pick_s, pick_p))
        can = torch.where(grow, ok_g, ok_s | elig_p.any(1))
        do_grow = grow | ~ok_s
        cur = k.gather(1, pick[:, None])[:, 0]
        new = torch.where(do_grow, cur * 2, cur // 2)
        upd = torch.where(need & can, new, cur)
        k = k.scatter(1, pick[:, None], upd[:, None])

    # balanced-code fallback for rows the moves did not repair
    K = k.sum(1)
    bad = (K != TAB) & (m >= 2)
    L = torch.clamp(floor_log2(torch.clamp(m - 1, min=1)) + 1, min=1)
    n_short = _pow2(L) - m
    order = torch.argsort(torch.where(used, -hist, torch.ones_like(hist)),
                          dim=1, stable=True)
    rank_of = torch.argsort(order, dim=1, stable=True)
    k_bal = torch.where(
        used,
        torch.where(rank_of < n_short[:, None],
                    _pow2(torch.clamp(12 - L, 1, 11))[:, None],
                    _pow2(torch.clamp(11 - L, 0, 10))[:, None]),
        zero)
    k = torch.where(bad[:, None], k_bal, k)

    # a flat code over > 127 symbols cannot be serialized: break the tie
    # Kraft-neutrally (double the most frequent, halve the two rarest)
    used_k = k > 0
    kmax = torch.where(used_k, k, zero).amax(1)
    kmin = torch.where(used_k, k, torch.full_like(k, 1 << 30)).amin(1)
    flat_bad = (m > 127) & (kmax == kmin) & (kmin >= 2) & (kmax < (1 << 10))
    big_i = torch.full_like(hist, 1 << 30)
    top = torch.where(used_k, hist, torch.full_like(hist, -1)).argmax(1)
    oh_top = torch.nn.functional.one_hot(top, 256).bool()
    b1 = torch.where(used_k & ~oh_top, hist, big_i).argmin(1)
    oh_b1 = torch.nn.functional.one_hot(b1, 256).bool()
    b2 = torch.where(used_k & ~oh_top & ~oh_b1, hist, big_i).argmin(1)
    oh_b2 = torch.nn.functional.one_hot(b2, 256).bool()
    fb = flat_bad[:, None]
    k = torch.where(fb & oh_top, k * 2, k)
    k = torch.where(fb & (oh_b1 | oh_b2), k // 2, k)
    return k


def canonical_from_kraft(k: torch.Tensor):
    """Kraft budgets -> (lengths, codes, weights, max_bits), values by
    HUF_buildCTable's valPerRank scheme (longest codes first, symbol
    order within a length)."""
    used = k > 0
    zero = torch.zeros_like(k)
    lengths = torch.where(used, MAX_BITS - floor_log2(k), zero)
    max_bits = lengths.amax(1)
    mn = torch.zeros_like(max_bits)
    val_per_rank = {}
    for nb in range(MAX_BITS, 0, -1):
        val_per_rank[nb] = mn
        mn = (mn + (lengths == nb).sum(1).to(torch.int32)) >> 1
    codes = zero
    for nb in range(1, MAX_BITS + 1):
        is_nb = lengths == nb
        pos = torch.cumsum(is_nb.to(torch.int32), 1, dtype=torch.int32) - 1
        codes = torch.where(is_nb, val_per_rank[nb][:, None] + pos, codes)
    weights = torch.where(used, max_bits[:, None] + 1 - lengths, zero)
    return lengths, codes, weights, max_bits


def pack_weights(weights: torch.Tensor) -> torch.Tensor:
    """(B, 256) weights in [0, 11] -> (B, 32) int32, 8 nibbles a word."""
    B = weights.shape[0]
    shifts = 4 * torch.arange(8, device=weights.device, dtype=torch.int64)
    w = weights.reshape(B, 32, 8).to(torch.int64) << shifts
    return u32_to_i32(w.sum(2))


def unpack_weights(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack_weights: (B, 32) int32 -> (B, 256)
    uint8."""
    B = packed.shape[0]
    p = packed.astype(np.uint32)[:, :, None]
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    return ((p >> shifts) & 0xF).reshape(B, 256).astype(np.uint8)


def plan_blocks(hist, lit_count, n_seq, const, lens, *, mode_huf: int,
                mode_huf1: int, mode_rawlit: int, mode_seq: int, hist_q):
    """Per-block literal planning.  Returns (mode_code (B,) per M_*,
    mode_bits (B,) for the entropy kernel, codes_packed (B, 256) =
    (value << 4) | nbits, weights_packed (B, 32), rle_byte (B,), sizes4
    (B, 4) exact per-stream byte sizes), all int32.  Decisions use
    provable bounds (tree size by its 4-bit direct form or the 128-byte
    format cap), since they are final before the entropy kernel runs."""
    lc = lit_count.to(torch.int32)
    blen = lens.to(torch.int32)
    nz = (hist > 0).sum(1)
    k = assign_kraft(hist)
    lengths, codes, weights, _ = canonical_from_kraft(k)
    codes_packed = (codes << 4) | lengths
    weights_packed = pack_weights(weights)
    rle_byte = hist.argmax(1).to(torch.int32)

    sym = torch.arange(256, device=hist.device, dtype=torch.int32)[None, :]
    last = torch.where(hist > 0, sym, torch.full_like(sym, -1)).amax(1)
    tree_bound = torch.where(last <= 127,
                             1 + (torch.clamp(last, min=0) + 1) // 2,
                             torch.full_like(last, 128))
    one = lc < 256
    jump = torch.where(one, 0, 6)
    est_bits = (hist * lengths).sum(1)
    bits_q = (hist_q * lengths[:, None, :]).sum(2)
    sz_q = (bits_q + 1 + 7) >> 3
    sz_one = (est_bits + 1 + 7) >> 3
    z = torch.zeros_like(sz_one)
    sizes4 = torch.where(one[:, None], torch.stack([sz_one, z, z, z], 1),
                         sz_q)
    est_payload = sizes4.sum(1) + tree_bound + jump
    raw_hdr = torch.where(lc < 32, 1, torch.where(lc < 4096, 2, 3))
    huf_hdr = torch.where((lc <= 1023) & (est_payload <= 1023), 3,
                          torch.where((lc <= 16383) & (est_payload <= 16383),
                                      4, 5))
    huf_ok = (nz >= 2) & (lc >= 64) & (est_payload < lc) & \
        (huf_hdr + est_payload < raw_hdr + lc)

    def full(v):
        return torch.full_like(lc, v)

    mode = torch.where(huf_ok, torch.where(one, full(M_HUF1), full(M_HUF)),
                       full(M_RAW))
    skip = (mode == M_RAW) & (lc > 0) & (raw_hdr + lc + 1 >= blen)
    mode = torch.where(skip, full(M_SKIP), mode)
    mode = torch.where(nz == 1, full(M_RLE), mode)
    mode = torch.where(lc == 0, full(M_NONE), mode)
    mode = torch.where((const >= 0) & (blen > 4), full(M_RLEBLOCK), mode)

    mb = torch.where(mode == M_HUF, full(mode_huf | mode_seq), full(0))
    mb = torch.where(mode == M_HUF1, full(mode_huf | mode_huf1 | mode_seq),
                     mb)
    mb = torch.where((mode == M_RAW) & (lc > 0), full(mode_rawlit | mode_seq),
                     mb)
    mb = torch.where((mode == M_NONE) | (mode == M_RLE) |
                     ((mode == M_RAW) & (lc == 0)), full(mode_seq), mb)
    mb = torch.where((mode == M_SKIP) | (mode == M_RLEBLOCK), full(0), mb)
    mb = torch.where(blen == 0, full(0), mb)
    mode = torch.where(blen == 0, full(M_SKIP), mode)
    sizes4 = torch.where(((mode == M_HUF) | (mode == M_HUF1))[:, None],
                         sizes4, torch.zeros_like(sizes4))
    i32 = lambda t: t.to(torch.int32)
    return (i32(mode), i32(mb), i32(codes_packed), weights_packed,
            rle_byte, i32(sizes4))


# --------------------------------------------------------------------
# both plans in one launch of csrc/plan.cu

launches = 0
_count = threading.Lock()   # the zstd stream's worker pipelines launch at once

# the offsets csrc/plan.cu is compiled with: a row's sequence-table pack
# (ops/entropy.py CTAB_OFF, CTAB_WIDTH), the norms' width and the constant
# table's length
KERNEL_LAYOUT = {"ll_st": 0, "ll_dnb": 512, "ll_dfs": 548, "of_st": 584,
                 "of_dnb": 840, "of_dfs": 869, "ml_st": 898, "ml_dnb": 1410,
                 "ml_dfs": 1463, "ctab_width": 1516, "norm_width": 118,
                 "table": 2694}


@functools.cache
def plan_table() -> np.ndarray:
    """The kernel's constant table (csrc/plan.cu T_*): the LL and ML code
    tables, the predefined costs in 1/16 bits of LL, OF and ML, COST16 at
    logs 5, 6, 8, 9, and the predefined sequence-table pack."""
    from libzseek_tpu_torch.ops import entropy as E
    from libzseek_tpu_torch.ops import fse_plan as fpl
    t = np.concatenate(
        [E.TABS[E.TAB_OFF["ll_code"]: E.TAB_OFF["ll_code"] + 64],
         E.TABS[E.TAB_OFF["ml_code"]: E.TAB_OFF["ml_code"] + 128]]
        + [fpl._PD_BITS16[s] for s in ("ll", "of", "ml")]
        + [fpl.COST16[lg] for lg in (5, 6, 8, 9)]
        + [E.CTAB_PREDEF]).astype(np.int32)
    layout = dict(E.CTAB_OFF, ctab_width=E.CTAB_WIDTH,
                  norm_width=fpl.NORM_WIDTH, table=len(t))
    if layout != KERNEL_LAYOUT:
        raise RuntimeError(f"csrc/plan.cu's layout is {KERNEL_LAYOUT}, the "
                           f"tables' {layout}")
    return t


def plan_all_cuda(hist, lit_count, n_seq, const, lens, *, mode_huf: int,
                  mode_huf1: int, mode_rawlit: int, mode_seq: int, hist_q,
                  ll, ml, offv):
    """plan_blocks and ops/fse_plan.py plan_seq_tables on the tensors'
    CUDA device in one launch: returns (plan_blocks' six arrays,
    plan_seq_tables' five), equal to theirs array for array, int32.
    ll/ml/offv (B, S) are the final sequences, n_seq (B,) their counts."""
    global launches
    from libzseek_tpu_torch import kernels
    from libzseek_tpu_torch.ops import entropy as E
    B, S = ll.shape
    if hist.shape != (B, 256) or hist_q.shape != (B, 4, 256) or \
            ml.shape != (B, S) or offv.shape != (B, S):
        raise ValueError("plan_all_cuda: hist (B, 256), hist_q (B, 4, 256) "
                         "and ll/ml/offv (B, S) expected")
    dev = hist.device
    ins = [t.to(torch.int32).contiguous() for t in (
        hist, hist_q, lit_count, n_seq, const, lens, ll, ml, offv)]
    shapes = ((B,), (B,), (B, 256), (B, 32), (B,), (B, 4), (B,),
              (B, KERNEL_LAYOUT["ctab_width"]),
              (B, KERNEL_LAYOUT["norm_width"]), (B, 3), (B,))
    sizes = [math.prod(sh) for sh in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    outs = [t.view(sh) for t, sh in zip(buf.split(sizes), shapes)]
    tabs = E._device_const("plan_table", plan_table(), dev)
    kernels.launch("zk_plan", dev, *[t.data_ptr() for t in ins],
                   tabs.data_ptr(), B, S, mode_huf, mode_huf1, mode_rawlit,
                   mode_seq, *[t.data_ptr() for t in outs])
    with _count:
        launches += 1
    return tuple(outs[:6]), tuple(outs[6:])
