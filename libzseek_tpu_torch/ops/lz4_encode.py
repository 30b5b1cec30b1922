"""LZ4 block encoder over the sort parser: LZ4Codec(parser="sort").

Counterpart of libzseek_tpu/ops/lz4_encode.py lz4_encode_blocks (:40),
_pack_lz4 (:87) and _ext_count (:32), as PyTorch ops: the match
pipeline of ops/match.py (greedy_select is the CUDA kernel
csrc/greedy_select.cu), then per-sequence geometry, closed-form encoded
sizes, prefix-sum output offsets, region fills and batched scatters.
The reference's lz4_encode_blocks_fast has no caller and is retired
(ROADMAP A11).

End-of-block rules: the last 5 bytes are literals, no match starts
within the last 12 bytes, and each block ends with a literals-only
sequence (LZ4 block format).
"""

from __future__ import annotations

import torch

from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops import match as M
from libzseek_tpu_torch.ops.lz4_emit import out_cap


def _ext_count(v: torch.Tensor) -> torch.Tensor:
    """Extension bytes of a length nibble value v (a literal length, or a
    match length - 4): 0 if v < 15 else 1 + (v - 15) // 255."""
    return torch.where(v < 15, torch.zeros_like(v), 1 + (v - 15) // 255)


def lz4_encode_blocks(x: torch.Tensor, lengths: torch.Tensor, *,
                      seg_size: int = 4, max_len: int = 48,
                      max_back: int = 4, dual: bool = True, ctx_len: int = 0,
                      min_ref: torch.Tensor | None = None):
    """Encode a batch of LZ4 blocks.  x (B, N) uint8 zero-padded rows,
    lengths (B,) int32 valid bytes.  Returns (out (B, M) uint8, out_lens
    (B,) int32), M the compress bound of N - ctx_len rounded up to 128;
    the frame layer stores a block raw where out_lens reaches its size.

    Linked blocks: each row carries the previous block's window as a
    ctx_len-byte prefix; the block's bytes start at ctx_len, matches may
    reach back into the prefix but not below min_ref (B,), the row's
    first real history byte."""
    B, N = x.shape
    nseq = (N - ctx_len) // seg_size + 1
    p, off, e, has = M.find_segment_matches(
        x, lengths, seg_size=seg_size, max_len=max_len, min_tail=12,
        max_back=max_back, dual=dual, ctx_len=ctx_len, min_ref=min_ref)
    sel, start, end, off, lit_from, c_final = M.greedy_select(
        p, off, e, has, lengths, min_tail=12, c0=ctx_len)
    is_head, merged_end = M.merge_runs(sel, start, end, off, lit_from)
    rank = torch.cumsum(is_head, 1, dtype=torch.int32) - 1
    n_heads = is_head.sum(1, dtype=torch.int32)
    zero = torch.zeros((B, nseq), dtype=torch.int32, device=x.device)
    seq_lit_from, seq_start, seq_end, seq_off = (
        C.scatter1_set(zero, rank, v, is_head)
        for v in (lit_from, start, merged_end, off))
    return _pack_lz4(x, lengths, seq_lit_from, seq_start, seq_end, seq_off,
                     n_heads, c_final, out_cap(N - ctx_len))


def _pack_lz4(x, lengths, seq_lit_from, seq_start, seq_end, seq_off,
              n_heads, c_final, Mcap: int):
    """Tokens, literals and offsets from per-sequence geometry into
    (B, Mcap) rows.  Positions may carry a context-prefix base; only their
    differences reach the output."""
    B, N = x.shape
    nseq = seq_start.shape[1]
    dev = x.device
    zero = torch.zeros((B, nseq), dtype=torch.int32, device=dev)
    idxs = torch.arange(nseq, device=dev)[None, :]
    # the final literals-only sequence sits at index n_heads
    final = idxs == n_heads[:, None]
    seq_lit_from = torch.where(final, c_final[:, None], seq_lit_from)
    seq_start = torch.where(final, lengths[:, None], seq_start)
    seq_end = torch.where(final, lengths[:, None], seq_end)
    valid = idxs <= n_heads[:, None]
    has_match = valid & ~final

    ll = torch.where(valid, seq_start - seq_lit_from, zero)
    ml = torch.where(has_match, seq_end - seq_start, zero)
    mlx = torch.clamp(ml - 4, min=0)          # the match length nibble
    ext_ll = torch.where(valid, _ext_count(ll), zero)
    ext_ml = torch.where(has_match, _ext_count(mlx), zero)
    seq_size = torch.where(
        valid, 1 + ext_ll + ll + torch.where(has_match, 2 + ext_ml, zero),
        zero)
    tp = C.exclusive_cumsum(seq_size, dim=1)  # each token's position
    out_lens = seq_size.sum(1, dtype=torch.int32)
    lit_out = tp + 1 + ext_ll
    mo = lit_out + ll                         # the offset field

    # 0xFF extension runs (disjoint regions across all sequences)
    ff = C.fill_regions(Mcap, torch.cat([tp + 1, mo + 2], 1),
                        torch.cat([tp + ext_ll, mo + 1 + ext_ml], 1),
                        torch.cat([valid & (ext_ll > 0),
                                   has_match & (ext_ml > 0)], 1))
    out = torch.where(ff, 0xFF, 0).to(torch.int32)
    token = (torch.clamp(ll, max=15) << 4) | \
        torch.where(has_match, torch.clamp(mlx, max=15), zero)
    out = C.scatter1_set(out, tp, token, valid)
    # extension terminators, then the little-endian offset
    out = C.scatter1_set(out, tp + ext_ll, (ll - 15) % 255,
                         valid & (ext_ll > 0))
    out = C.scatter1_set(out, mo + 1 + ext_ml, (mlx - 15) % 255,
                         has_match & (ext_ml > 0))
    out = C.scatter1_set(out, mo, seq_off & 0xFF, has_match)
    out = C.scatter1_set(out, mo + 1, seq_off >> 8, has_match)

    # literal bytes: each input literal finds its run through the start
    # markers and lands at the run's output position plus its rank
    has_lits = valid & (ll > 0)
    is_lit = C.fill_regions(N, seq_lit_from, seq_start, has_lits)
    lr_rank = torch.cumsum(has_lits, 1, dtype=torch.int32) - 1
    lit_from_tab = C.scatter1_set(zero, lr_rank, seq_lit_from, has_lits)
    lit_out_tab = C.scatter1_set(zero, lr_rank, lit_out, has_lits)
    region = C.region_index(N, seq_lit_from, has_lits)
    dst = C.take1(lit_out_tab, region) + (
        torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        - C.take1(lit_from_tab, region))
    out = C.scatter1_set(out, dst, x.to(torch.int32), is_lit)
    return out.to(torch.uint8), out_lens
