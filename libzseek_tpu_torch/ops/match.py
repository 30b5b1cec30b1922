"""The sort parser's LZ77 match finding: exact nearest previous
occurrences by a batched sort, per-segment candidates, greedy coverage
and run merging.

Counterpart of libzseek_tpu/ops/match.py: nearest_prev_occurrence (:35),
extend_match_lengths (:69), backward_extension (:99),
find_segment_matches (:128), greedy_select (:213) and merge_runs (:261);
its _log2i (:119) is ops/entropy.exp_of.
Those are XLA code, not Pallas, so they are PyTorch ops here, except
greedy_select: the reference's lax.scan over the segments becomes the
CUDA kernel csrc/greedy_select.cu (greedy_select_plain is its plain
version, for tensors on the CPU).

Sort keys: the reference sorts (invalid, value[, value2], position)
lexicographically.  Here a stable torch.sort keeps equal keys in position
order, so the 4-byte window sorts one int64 key invalid << 32 | value
(the value unsigned), and the 8-byte window, whose key would need 65
bits, sorts twice: first by value2, then stably by invalid << 32 |
value.  Only the grouping of equal windows and the position order inside
a group matter, so the order of the groups may differ from the
reference's without changing a candidate.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops.entropy import exp_of

launches = 0
_count = threading.Lock()

_NEG = -(1 << 30)


def _positions(B: int, N: int, dev) -> torch.Tensor:
    return torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)


def nearest_prev_occurrence(x: torch.Tensor, lengths: torch.Tensor,
                            window: int = 4) -> torch.Tensor:
    """cand[b, i] = largest j < i with x[b, j:j+window] == x[b,
    i:i+window], else -1 (int32); window is 4 or 8, and positions i >
    lengths[b] - window get -1."""
    B, N = x.shape
    v = C.u32_window(x)
    pos = _positions(B, N, x.device)
    invalid = pos > lengths[:, None] - window
    key = (invalid.to(torch.int64) << 32) | v
    if window == 4:
        _, idx_s = torch.sort(key, dim=1, stable=True)
        key_s = torch.gather(key, 1, idx_s)
    else:
        v2 = torch.nn.functional.pad(v[:, 4:], (0, 4))  # bytes i+4..i+7
        _, by2 = torch.sort(v2, dim=1, stable=True)
        _, idx = torch.sort(torch.gather(key, 1, by2), dim=1, stable=True)
        idx_s = torch.gather(by2, 1, idx)
        key_s = torch.gather(key, 1, idx_s)
        v2_s = torch.gather(v2, 1, idx_s)
    valid_s = (key_s >> 32) == 0
    same = valid_s[:, 1:] & valid_s[:, :-1] & (key_s[:, 1:] == key_s[:, :-1])
    if window != 4:
        same &= v2_s[:, 1:] == v2_s[:, :-1]
    none = torch.full((B, N), C.INVALID, dtype=torch.int32, device=x.device)
    cand_s = torch.cat([none[:, :1], torch.where(
        same, idx_s[:, :-1].to(torch.int32), none[:, 1:])], 1)
    cand = torch.empty_like(none).scatter_(1, idx_s, cand_s)
    return torch.where(invalid, none, cand)


def extend_match_lengths(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                         active: torch.Tensor, max_len: int,
                         v: torch.Tensor | None = None) -> torch.Tensor:
    """Length of the match between positions p and q (< p) per row, in
    [4, max_len], in 4-byte strides with a partial last word.  x (B, N)
    uint8; p, q, active (B, K).  Reads may run past the valid length into
    zero padding (callers cap the result); `v` is x's u32_window when the
    caller has it."""
    if v is None:
        v = C.u32_window(x)
    length = torch.full_like(p, 4)
    alive = active
    zero = torch.zeros_like(p)
    for _ in range(max(0, (max_len - 4 + 3) // 4)):
        d = C.take1(v, p + length) ^ C.take1(v, q + length)
        full = (d == 0) & alive
        partial = (((d & 0xFF) == 0).to(p.dtype)
                   + ((d & 0xFFFF) == 0).to(p.dtype)
                   + ((d & 0xFFFFFF) == 0).to(p.dtype))
        length = length + torch.where(
            full, zero + 4, torch.where(alive & (d != 0), partial, zero))
        alive = full
    return torch.clamp(length, 4, max_len)


def backward_extension(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                       active: torch.Tensor, max_back: int, min_p: int = 0,
                       min_q: torch.Tensor | None = None) -> torch.Tensor:
    """How many bytes before p also match before q, in [0, max_back]
    (B, K) int32: greedy LZ4's backward extension over pending literals.
    min_p keeps the match start out of a context prefix, min_q (B,) keeps
    the reference inside valid history."""
    bk = torch.zeros_like(p)
    alive = active
    qlim = 0 if min_q is None else min_q[:, None]
    for t in range(1, max_back + 1):
        a = C.take1(x, p - t)
        b = C.take1(x, q - t)
        alive = alive & (q - t >= qlim) & (p - t >= min_p) & (a == b)
        bk = bk + alive.to(p.dtype)
    return bk


def find_segment_matches(x: torch.Tensor, lengths: torch.Tensor, *,
                         seg_size: int = 8, max_len: int = 64,
                         max_offset: int = 65535, min_tail: int = 12,
                         max_back: int = 0, end_margin: int = 5,
                         dual: bool = False, ctx_len: int = 0,
                         min_ref: torch.Tensor | None = None,
                         window: int = 4):
    """Per-segment match candidates: the earliest valid match start in
    each seg_size-byte segment, with its offset and extended length.
    Returns (p, off, e, has), each (B, N / seg_size): the match start
    (after the backward extension), its distance, its end (capped at
    lengths - end_margin and start + max_len) and whether the segment has
    a candidate.

    min_tail / end_margin carry LZ4's end-of-block rules (zstd callers
    pass 4 and 0).  dual=True adds each segment's nearest 8-byte-window
    candidate and keeps the better of the two by (length, offset cost),
    scored before the extension.  ctx_len > 0: positions [0, ctx_len) are
    history only (matches start at or after ctx_len), and min_ref (B,)
    bounds how far back a reference may reach."""
    B, N = x.shape
    if N % seg_size:
        raise ParameterError(f"row length {N} is not a multiple of "
                             f"seg_size {seg_size}")
    nseg = N // seg_size
    dev = x.device
    lengths = lengths.to(torch.int32)
    pos = _positions(B, N, dev)
    segbase = torch.arange(nseg, dtype=torch.int32, device=dev)[None, :] \
        * seg_size
    inner = torch.arange(seg_size, dtype=torch.int32, device=dev)
    v = C.u32_window(x)

    def seg_candidate(win):
        cand = nearest_prev_occurrence(x, lengths, win)
        valid = (cand >= 0) & (pos - cand <= max_offset) & \
            (pos <= lengths[:, None] - min_tail)
        if ctx_len:
            valid &= pos >= ctx_len
        if min_ref is not None:
            valid &= cand >= min_ref[:, None]
        vseg = valid.reshape(B, nseg, seg_size)
        has = vseg.any(2)
        first = torch.where(vseg, inner, seg_size).amin(2)
        p = segbase + torch.where(has, first, torch.zeros_like(first))
        return p, C.take1(cand, p), has

    p, q, has = seg_candidate(window)
    if dual:
        # pick the winner before the expensive extension: one word bounds
        # the 4-window candidate's promise, the 8-window one is >= 8 long
        p8, q8, has8 = seg_candidate(8)
        l4p = extend_match_lengths(x, p, q, has, 8, v)
        neg = torch.full_like(p, _NEG)
        score4 = torch.where(has, 8 * l4p - exp_of(p - q), neg)
        score8 = torch.where(has8, 64 - exp_of(p8 - q8), neg)
        use8 = score8 > score4
        p = torch.where(use8, p8, p)
        q = torch.where(use8, q8, q)
        has = has | has8
    length = extend_match_lengths(x, p, q, has, max_len, v)
    if max_back > 0:
        bk = backward_extension(x, p, q, has, max_back, min_p=ctx_len,
                                min_q=min_ref)
        p = p - bk
        q = q - bk
        length = length + bk
    e = torch.minimum(p + length, lengths[:, None] - end_margin)
    return p, p - q, e, has & (e - p >= 4)


def greedy_select(p, off, e, has, lengths, min_tail: int = 12,
                  min_match: int = 4, c0: int = 0):
    """Greedy left-to-right coverage over segments, batched over rows:
    the carry is each row's cover end c (from c0); a segment's match is
    selected if it still has >= min_match bytes past c (its start trimmed
    to c) and that start is <= lengths - min_tail.  Returns (sel, start,
    e, off, lit_from, c_final): per segment the selection, the trimmed
    start, the end and offset it was given and the cover end before it,
    and each row's final cover end.  p, e (B, nseg) int32, has (B, nseg)
    bool, lengths (B,) int32, all on one device; CUDA tensors launch
    csrc/greedy_select.cu, CPU tensors take greedy_select_plain."""
    B, nseg = p.shape
    for name, t, dt in (("p", p, torch.int32), ("e", e, torch.int32),
                        ("has", has, torch.bool)):
        if t.shape != (B, nseg) or t.dtype != dt or t.device != p.device:
            raise ParameterError(f"greedy_select: {name} must be ({B}, "
                                 f"{nseg}) {dt} on {p.device}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != p.device:
        raise ParameterError(f"greedy_select: lengths must be ({B},) int32 "
                             f"on {p.device}")
    if min_match < 0:
        raise ParameterError("greedy_select: min_match must be >= 0")
    if p.device.type == "cpu":
        sel, start, lit_from, c_final = greedy_select_plain(
            p, e, has, lengths, min_tail, min_match, c0)
    elif p.device.type == "cuda":
        sel, start, lit_from, c_final = _greedy_cuda(
            p, e, has, lengths, min_tail, min_match, c0)
    else:
        raise ParameterError(f"greedy_select runs on cuda or cpu tensors, "
                             f"not {p.device}")
    return sel, start, e, off, lit_from, c_final


def _greedy_cuda(p, e, has, lengths, min_tail, min_match, c0):
    """One warp a row (csrc/greedy_select.cu)."""
    global launches
    B, nseg = p.shape
    dev = p.device
    sel = torch.empty((B, nseg), dtype=torch.bool, device=dev)
    start = torch.empty((B, nseg), dtype=torch.int32, device=dev)
    lit_from = torch.empty_like(start)
    c_final = torch.full((B,), c0, dtype=torch.int32, device=dev)
    if B == 0 or nseg == 0:
        return sel, start, lit_from, c_final
    from libzseek_tpu_torch import kernels
    p, e, has, lengths = (t.contiguous() for t in (p, e, has, lengths))
    kernels.launch(
        "zk_greedy_select", dev, p.data_ptr(), e.data_ptr(), has.data_ptr(),
        lengths.data_ptr(), B, nseg, min_tail, min_match, c0, sel.data_ptr(),
        start.data_ptr(), lit_from.data_ptr(), c_final.data_ptr())
    with _count:
        launches += 1
    return sel, start, lit_from, c_final


def greedy_select_plain(p, e, has, lengths, min_tail: int, min_match: int,
                        c0: int):
    """The plain version over (B,) numpy vectors: only segments with `has`
    can move the cover end, so the walk steps through each row's has
    segments in order (as many steps as the busiest row has), and every
    segment's cover end before it follows by a running maximum of the
    cover ends after the steps (c never decreases: a selected end lies at
    least min_match >= 0 bytes past it).  Returns (sel, start, lit_from,
    c_final) tensors on the CPU."""
    P = p.numpy().astype(np.int64)
    E = e.numpy().astype(np.int64)
    H = has.numpy()
    B, nseg = P.shape
    tail = lengths.numpy().astype(np.int64) - min_tail
    cnt = H.sum(1)
    K = int(cnt.max()) if B and nseg else 0
    order = np.argsort(~H, axis=1, kind="stable")[:, :K]
    live = np.arange(K)[None, :] < cnt[:, None]
    Pk = np.ascontiguousarray(np.take_along_axis(P, order, 1).T)
    Ek = np.ascontiguousarray(np.take_along_axis(E, order, 1).T)
    okT = np.zeros((K, B), bool)
    afterT = np.zeros((K, B), np.int64)
    c = np.full(B, c0, np.int64)
    for t in range(K):
        s = np.maximum(Pk[t], c)
        ok = live[:, t] & (Ek[t] - s >= min_match) & (s <= tail)
        c = np.where(ok, Ek[t], c)
        okT[t] = ok
        afterT[t] = c
    sel = np.zeros((B, nseg), bool)
    after = np.full((B, nseg), c0, np.int64)
    rows = np.nonzero(live)[0]
    cols = order[live]
    sel[rows, cols] = okT.T[live]
    after[rows, cols] = afterT.T[live]
    run = np.maximum.accumulate(after, axis=1)
    lit_from = np.concatenate([np.full((B, 1), c0, np.int64),
                               run[:, :-1]], 1)[:, :nseg]
    start = np.maximum(P, lit_from)
    t32 = lambda a: torch.from_numpy(a.astype(np.int32))
    return torch.from_numpy(sel), t32(start), t32(lit_from), t32(c)


def merge_runs(sel, start, end, off, lit_from):
    """Merge adjacent selected matches that continue seamlessly (the
    previous one ends where this one starts, same offset, no literals
    between) into single long sequences.  Returns (is_head, merged_end):
    heads keep their start, offset and lit_from; merged_end is the end of
    the last member of the head's run."""
    B, nseg = sel.shape
    dev = sel.device
    seg_idx = torch.arange(nseg, dtype=torch.int32, device=dev).expand(
        B, nseg)
    marked = torch.where(sel, seg_idx, torch.full_like(seg_idx, -1))
    prev_sel = torch.cummax(torch.nn.functional.pad(
        marked[:, :-1], (1, 0), value=-1), 1).values
    prev = torch.clamp(prev_sel, min=0)
    cont = sel & (prev_sel >= 0) & (C.take1(end, prev) == start) & \
        (C.take1(off, prev) == off)
    is_head = sel & ~cont
    run_id = torch.cumsum(is_head, 1, dtype=torch.int32) - 1
    slot = torch.where(sel, run_id, torch.full_like(run_id, nseg)).long()
    ends = torch.zeros((B, nseg + 1), dtype=end.dtype, device=dev)
    ends.scatter_reduce_(1, slot, torch.where(sel, end, torch.zeros_like(end)),
                         "amax")
    return is_head, C.take1(ends, torch.clamp(run_id, min=0))
