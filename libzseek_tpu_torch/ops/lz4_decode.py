"""LZ4 frame decode: a hand-written CUDA decoder and its plain version.

The plain version is a copy of libzseek_tpu/ops/lz4_decode.py
lz4_decode_frames (:110) and _parse_blocks (:35) in torch ops: a loop over
sequences vectorised over every block of the batch (extension-byte runs
precomputed), then frame-wide execution by literal scatter and
pointer-doubling copy resolution.  It runs only for tensors on the CPU.

The reference's decoder is XLA, not a Pallas kernel.  In torch ops on the
card its sequence loop would be thousands of tiny launches with a host
sync per step, so on CUDA tensors the decode is csrc/lz4_decode.cu, in
the reference's phases: one warp per LZ4 block parses its tokens from
shared memory into one record a sequence; the blocks' lengths give their
bases; literals are scattered and match bytes resolved by pointer
doubling over one source index an output byte.  The failure flags are
the plain version's.  parse_records and resolve_records below mirror
those phases in numpy; only the tests call them.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.ops import common as C

launches = 0
_count = threading.Lock()     # the codec decodes from two reader threads


def lz4_decode_frames(comp: torch.Tensor, comp_lens: torch.Tensor,
                      uncompressed: torch.Tensor, out_size: int,
                      max_seqs: int | None = None, linked: bool = False):
    """Decode a batch of frames, each given as K zero-padded blocks.

    comp (B, K, M) uint8; comp_lens (B, K) int32 (0 = absent block);
    uncompressed (B, K) bool (the LZ4F uncompressed-block flag); out_size
    F, the per-frame output capacity.  Linked frames' matches may reach
    back to the frame's first byte, independent frames' to their block's
    start.  Returns (out (B, F) uint8, out_lens (B,) int32, ok (B,) bool);
    ok is False for a truncated or overrunning block, an offset of 0, an
    offset past the block start (independent frames), a reference before
    the frame start, or more than max_seqs sequences in a block.  Nothing
    is written past F."""
    B, K, M = comp.shape
    dev = comp.device
    F = int(out_size)
    if max_seqs is None:
        max_seqs = min(M // 3 + 2, F // 4 + 2)
    for name, t, dt in (("comp_lens", comp_lens, torch.int32),
                        ("uncompressed", uncompressed, torch.bool)):
        if t.dtype != dt or t.device != dev or tuple(t.shape) != (B, K):
            raise ParameterError(f"LZ4 decode: {name} must be a {dt} "
                                 f"({B}, {K}) tensor on {dev}")
    if comp.dtype != torch.uint8:
        raise ParameterError("LZ4 decode: comp must be uint8")
    if F < 1 or max_seqs < 1:
        raise ParameterError("LZ4 decode: out_size and max_seqs must be "
                             "positive")
    if dev.type == "cpu":
        return _decode_plain(comp, comp_lens, uncompressed, F, max_seqs,
                             linked)
    if dev.type != "cuda":
        raise ParameterError(f"LZ4 decode runs on cuda or cpu tensors, not "
                             f"{dev}")
    global launches
    from libzseek_tpu_torch import kernels
    comp = comp.contiguous()
    clens = comp_lens.contiguous()
    unc = uncompressed.contiguous()
    L = B * K
    rounds = _rounds(F)
    out = torch.zeros((B, F), dtype=torch.uint8, device=dev)
    out_lens = torch.empty((B,), dtype=torch.int32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    rec = torch.empty((L, max_seqs, 4), dtype=torch.int32, device=dev)
    srcs = torch.empty((B, F), dtype=torch.int32, device=dev)
    meta = torch.zeros((3 * L + 2 * B + rounds,), dtype=torch.int32,
                       device=dev)
    kernels.launch(
        "zk_lz4_decode", dev, comp.data_ptr(), clens.data_ptr(),
        unc.data_ptr(), B, K, M, F, max_seqs, int(linked), out.data_ptr(),
        out_lens.data_ptr(), ok.data_ptr(), rec.data_ptr(), srcs.data_ptr(),
        meta.data_ptr(), rounds)
    with _count:
        launches += 1
    return out, out_lens, ok


# --------------------------------------------------------------------
# plain version: the reference's vectorised decode in torch ops


def _parse_blocks(comp, comp_lens, max_seqs: int, linked: bool):
    """Phase A over a flat batch of blocks: comp (L, M), comp_lens (L,).
    Returns per-sequence (L, max_seqs) lit_src, lit_len, lit_dst
    (block-local), m_off, m_len, m_dst (block-local), and out_lens, bad
    (L,)."""
    L, _ = comp.shape
    ff = C.ff_run_length(comp, 0xFF)
    compi = comp.to(torch.int32)

    def g(idx):
        return C.take1(compi, idx)

    z = torch.zeros((L,), dtype=torch.int32)
    ip, op = z.clone(), z.clone()
    active = comp_lens > 0
    bad = torch.zeros((L,), dtype=torch.bool)
    cols = [torch.zeros((L, max_seqs), dtype=torch.int32) for _ in range(6)]
    lit_src, lit_len, lit_dst, m_off, m_len, m_dst = cols
    k = 0
    while k < max_seqs and bool(active.any()):
        token = g(ip)
        ll0 = token >> 4
        ll_ext = ll0 == 15
        ffr = C.take1(ff, ip + 1)
        ll_extbytes = torch.where(ll_ext, ffr + 1, z)
        ll = torch.where(ll_ext, 15 + 255 * ffr + g(ip + 1 + ffr), ll0)
        src = ip + 1 + ll_extbytes
        dst = op
        lit_end = src + ll
        is_last = lit_end >= comp_lens
        ml0 = token & 15
        off = g(lit_end) | (g(lit_end + 1) << 8)
        ml_ext = ml0 == 15
        ffr2 = C.take1(ff, lit_end + 2)
        ml_extbytes = torch.where(ml_ext, ffr2 + 1, z)
        ml = torch.where(ml_ext, 4 + 15 + 255 * ffr2
                         + g(lit_end + 2 + ffr2), ml0 + 4)
        ml = torch.where(is_last, z, ml)
        match_dst = op + ll
        overrun = (lit_end > comp_lens) | \
            (~is_last & (lit_end + 2 + ml_extbytes > comp_lens)) | \
            (~is_last & (off == 0))
        if not linked:
            overrun = overrun | (~is_last & (off > match_dst))
        bad = bad | (active & overrun)
        upd = active & ~bad
        for col, vals in ((lit_src, src), (lit_len, ll), (lit_dst, dst),
                          (m_off, off), (m_len, ml), (m_dst, match_dst)):
            col[:, k] = torch.where(upd, vals, z)
        ip = torch.where(upd & ~is_last, lit_end + 2 + ml_extbytes, ip)
        op = torch.where(upd, match_dst + ml, op)
        active = upd & ~is_last
        k += 1
    bad = bad | active  # ran out of sequence budget mid-block
    return lit_src, lit_len, lit_dst, m_off, m_len, m_dst, op, bad


def _decode_plain(comp, comp_lens, uncompressed, F, max_seqs, linked):
    B, K, Mcap = comp.shape
    flat = comp.reshape(B * K, Mcap)
    flat_lens = comp_lens.reshape(B * K)
    flat_unc = uncompressed.reshape(B * K)
    # uncompressed blocks skip the parser entirely
    parse_lens = torch.where(flat_unc, torch.zeros_like(flat_lens),
                             flat_lens)
    (lit_src, lit_len, lit_dst, m_off, m_len, m_dst,
     blk_out, bad) = _parse_blocks(flat, parse_lens, max_seqs, linked)
    # a single whole-block literal sequence for uncompressed blocks
    zero = torch.zeros_like(flat_lens)
    lit_src[:, 0] = torch.where(flat_unc, zero, lit_src[:, 0])
    lit_len[:, 0] = torch.where(flat_unc, flat_lens, lit_len[:, 0])
    lit_dst[:, 0] = torch.where(flat_unc, zero, lit_dst[:, 0])
    m_len[:, 0] = torch.where(flat_unc, zero, m_len[:, 0])
    blk_out = torch.where(flat_unc, flat_lens, blk_out)

    # per-frame block output bases (exclusive scan)
    blk_out_bk = blk_out.reshape(B, K)
    base = C.exclusive_cumsum(blk_out_bk, 1)
    out_lens = blk_out_bk.sum(1, dtype=torch.int32)

    # sequences frame-wide: (B, K*S)
    S = max_seqs
    nseq = K * S

    def to_frame(arr):
        return arr.reshape(B, nseq)

    base_rep = torch.repeat_interleave(base, S, dim=1)
    blk_idx = torch.repeat_interleave(
        torch.arange(K, dtype=torch.int32), S)[None, :]
    lit_src_f = to_frame(lit_src) + blk_idx * Mcap
    lit_len_f = to_frame(lit_len)
    lit_dst_f = to_frame(lit_dst) + base_rep
    m_off_f = to_frame(m_off)
    m_len_f = to_frame(m_len)
    m_dst_f = to_frame(m_dst) + base_rep
    bad_f = bad.reshape(B, K).any(1)
    comp_frame = comp.reshape(B, K * Mcap)

    # literals: comp-stream membership -> output scatter, via
    # rank-compacted tables (region_index ranks among masked starts only)
    seq_valid = lit_len_f > 0
    is_lit_src = C.fill_regions(K * Mcap, lit_src_f, lit_src_f + lit_len_f,
                                seq_valid)
    src_region = C.region_index(K * Mcap, lit_src_f, seq_valid)
    lr_rank = torch.cumsum(seq_valid.to(torch.int32), 1) - 1
    tab0 = torch.zeros((B, nseq), dtype=torch.int32)
    lit_src_tab = C.scatter1_set(tab0, lr_rank, lit_src_f, seq_valid)
    lit_dst_tab = C.scatter1_set(tab0, lr_rank, lit_dst_f, seq_valid)
    jpos = torch.arange(K * Mcap, dtype=torch.int32).expand(B, K * Mcap)
    ldst = C.take1(lit_dst_tab, src_region) + \
        (jpos - C.take1(lit_src_tab, src_region))
    val_layer = C.scatter1_set(torch.zeros((B, F), dtype=torch.int32), ldst,
                               comp_frame.to(torch.int32), is_lit_src)

    # matches: output membership -> frame-wide back references
    m_valid = m_len_f > 0
    in_match = C.fill_regions(F, m_dst_f, m_dst_f + m_len_f, m_valid)
    m_region = C.region_index(F, m_dst_f, m_valid)
    mr_rank = torch.cumsum(m_valid.to(torch.int32), 1) - 1
    m_off_tab = C.scatter1_set(torch.ones((B, nseq), dtype=torch.int32),
                               mr_rank, m_off_f, m_valid)
    ipos = torch.arange(F, dtype=torch.int32).expand(B, F)
    ref = ipos - C.take1(m_off_tab, m_region)
    bad_f = bad_f | (in_match & (ref < 0)).any(1)
    src0 = torch.where(in_match, ref.clamp(0, F - 1), ipos)
    src_final = C.resolve_copy_chains(src0, _rounds(F))
    out = C.take1(val_layer, src_final).to(torch.uint8)
    return out, out_lens, ~bad_f


def _rounds(F: int) -> int:
    """Pointer-doubling rounds that resolve any copy chain in F bytes."""
    return max(1, int(math.ceil(np.log2(max(2, F)))))


# --------------------------------------------------------------------
# the kernel's phases in numpy, for the tests


def parse_records(comp: np.ndarray, comp_lens: np.ndarray,
                  uncompressed: np.ndarray, max_seqs: int, linked: bool):
    """Phase 1 (parse_kernel) on a flat batch of blocks: comp (L, M)
    uint8, comp_lens (L,), uncompressed (L,) bool.  Returns rec (L,
    max_seqs, 4) int32, one {literal source, ll, output position, offset}
    per sequence, block-local (zero past each block's count; offset 0 on
    a last, literal-only sequence), and nrec, blen (output bytes), bad,
    each (L,) int32."""
    L, M = comp.shape
    rec = np.zeros((L, max_seqs, 4), np.int64)
    nrec = np.zeros(L, np.int64)
    blen = np.zeros(L, np.int64)
    bad = np.zeros(L, np.int64)
    for blk in range(L):
        clen = int(comp_lens[blk])
        if uncompressed[blk]:
            rec[blk, 0] = (0, clen, 0, 0)
            nrec[blk], blen[blk] = 1, clen
            continue
        if clen <= 0:
            continue
        row = comp[blk].tolist()

        def at(i):
            return row[min(max(i, 0), M - 1)]

        def ff_run(i):
            i = min(max(i, 0), M - 1)
            n = 0
            while i + n < M and row[i + n] == 0xFF:
                n += 1
            return n

        ip = op = s = 0
        while True:
            if s == max_seqs:
                bad[blk] = 1
                break
            token = at(ip)
            ll, llx = token >> 4, 0
            if ll == 15:
                f = ff_run(ip + 1)
                llx, ll = f + 1, 15 + 255 * f + at(ip + 1 + f)
            src = ip + 1 + llx
            lit_end = src + ll
            last = lit_end >= clen
            off = at(lit_end) | (at(lit_end + 1) << 8)
            ml, mlx = (token & 15) + 4, 0
            if token & 15 == 15:
                f = ff_run(lit_end + 2)
                mlx, ml = f + 1, 19 + 255 * f + at(lit_end + 2 + f)
            over = lit_end > clen or (not last and (
                lit_end + 2 + mlx > clen or off == 0))
            if not linked:
                over = over or (not last and off > op + ll)
            if over:
                bad[blk] = 1
                break
            rec[blk, s] = (src, ll, op, 0 if last else off)
            s += 1
            if last:
                op += ll
                break
            op += ll + ml
            ip = lit_end + 2 + mlx
        nrec[blk], blen[blk] = s, op
    i32 = lambda a: a.astype(np.int32)
    return i32(rec), i32(nrec), i32(blen), i32(bad)


def resolve_records(comp: np.ndarray, rec, nrec, blen, bad, F: int):
    """Phases 2 and 3 (expand_kernel, round_kernel, finish_kernel):
    comp (B, K, M) and the records of its B*K blocks -> out (B, F)
    uint8, out_lens (B,) int32, ok (B,) bool.  Literal bytes land in the
    output; each match byte takes its source index, folded back before
    its match's start (a match reaching before the frame copies
    nothing); pointer doubling then leads every index to a byte that is
    no match byte, whose value it copies."""
    B, K, M = comp.shape
    out = np.zeros((B, F), np.uint8)
    out_lens = np.zeros(B, np.int32)
    ok = np.zeros(B, bool)
    for b in range(B):
        flat = comp[b].reshape(-1)
        src = np.full(F, -1, np.int64)
        base = 0
        before = False
        for k in range(K):
            blk = b * K + k
            n = int(nrec[blk])
            for i in range(n):
                x, ll, z, off = (int(v) for v in rec[blk, i])
                nxt = int(rec[blk, i + 1, 2]) if i + 1 < n else int(blen[blk])
                ld, ml = base + z, nxt - z - ll
                mdst = ld + ll
                j = np.arange(max(0, min(ll, F - ld)))
                s = k * M + x + j
                out[b, ld + j] = np.where(s < K * M,
                                          flat[np.minimum(s, K * M - 1)], 0)
                if ml <= 0 or mdst >= F:
                    continue
                j = np.arange(min(ml, F - mdst))
                if mdst - off < 0:
                    before = True
                    continue
                src[mdst + j] = mdst - off + (j % off)
            base += int(blen[blk])
        lim = min(base, F)
        s = src[:lim]
        for _ in range(_rounds(F)):
            live = s >= 0
            nxt = np.where(live, s[np.maximum(s, 0)], -1)
            hop = live & (nxt >= 0)
            if not hop.any():
                break
            s = np.where(hop, nxt, s)
        live = s >= 0
        out[b, :lim][live] = out[b, s[live]]
        out_lens[b] = np.int64(base).astype(np.int32)
        ok[b] = not (before or bad[b * K: (b + 1) * K].any())
    return out, out_lens, ok
