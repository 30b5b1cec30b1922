"""Batched histogram, prefix-sum, gather/scatter and region helpers.

Counterparts of libzseek_tpu/ops/common.py INVALID (:19), u32_window
(:22), hist256 (:117), hist_nk (:144), exclusive_cumsum (:36), and of
the helpers of the LZ4 decoder's plain version and the sort parser:
take1 (:41), scatter1_set (:53), scatter1_add (:63), fill_regions (:72),
region_index (:89), ff_run_length (:102) and resolve_copy_chains
(:169).  The reference builds histograms as bf16
one-hot matmuls with f32 accumulation (exact for counts, and the fast
form on the TPU's matrix unit); here they are plain `scatter_add_`
counts, exact by construction.  Batched arrays are (B, N): rows are
independent blocks or frames.
"""

from __future__ import annotations

import torch

INVALID = -1


def u32_window(x: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte value starting at every position: (B, N)
    uint8 -> (B, N) int64 holding the unsigned 32-bit value (positions
    N-3.. read zero padding; callers mask by valid length).  The
    reference returns the same bits as int32."""
    xi = x.to(torch.int64)
    out = xi.clone()
    for k in (1, 2, 3):
        out[:, : -k] |= xi[:, k:] << (8 * k)
    return out


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def hist_nk(vals: torch.Tensor, mask: torch.Tensor,
            nbins: int) -> torch.Tensor:
    """Masked per-row histogram over values in [0, nbins):
    (B, N) ints + (B, N) bool -> (B, nbins) int32."""
    B = vals.shape[0]
    out = torch.zeros((B, nbins), dtype=torch.int32, device=vals.device)
    out.scatter_add_(1, vals.long(), mask.to(torch.int32))
    return out


def hist256(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked per-row byte histogram: (B, N) uint8 + (B, N) bool ->
    (B, 256) int32."""
    return hist_nk(x, mask, 256)


def u32_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    t = t & 0xFFFFFFFF
    return (t - ((t >> 31) << 32)).to(torch.int32)


def place_bits(vals: torch.Tensor, pos: torch.Tensor, live: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """OR every live value (< 2^32) in at its absolute bit position of
    its row's little-endian word buffer: (B, ...) -> (B, n_words) int32
    words.  Callers guarantee disjoint bit ranges, so sums equal ORs."""
    B = vals.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=vals.device)
    v = torch.where(live, vals.to(torch.int64), zero).reshape(B, -1)
    p = torch.where(live, pos.to(torch.int64), zero).reshape(B, -1)
    w = p >> 5
    sh = v << (p & 31)
    out = torch.zeros((B, n_words + 1), dtype=torch.int64,
                      device=vals.device)
    out.scatter_add_(1, w, sh & 0xFFFFFFFF)
    out.scatter_add_(1, w + 1, sh >> 32)
    return u32_to_i32(out[:, :n_words])


def take1(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along dim 1 with clamped indices: table (B, T),
    idx (B, ...) -> (B, ...)."""
    T = table.shape[1]
    flat = idx.reshape(idx.shape[0], -1).clamp(0, T - 1).long()
    return torch.gather(table, 1, flat).reshape(idx.shape)


def _scatter1(dst, idx, vals, mask, reduce):
    """Batched scatter along dim 1 into a copy of dst; indices outside
    [0, T) and masked-out entries are dropped."""
    B, T = dst.shape
    keep = (idx >= 0) & (idx < T)
    if mask is not None:
        keep = keep & mask
    where = torch.where(keep, idx, T).reshape(B, -1).long()
    vals = torch.broadcast_to(vals, idx.shape).reshape(B, -1).to(dst.dtype)
    ext = torch.cat([dst, dst.new_zeros((B, 1))], 1)
    if reduce == "set":
        ext.scatter_(1, where, vals)
    else:
        ext.scatter_add_(1, where, vals)
    return ext[:, :T]


def scatter1_set(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched scatter-set along dim 1; masked-out entries are dropped."""
    return _scatter1(dst, idx, vals, mask, "set")


def scatter1_add(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    return _scatter1(dst, idx, vals, mask, "add")


def fill_regions(length: int, starts: torch.Tensor, ends: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Bool (B, length), True inside each [start, end) region (regions
    disjoint per row): +1/-1 boundary markers and a cumulative sum."""
    B = starts.shape[0]
    markers = torch.zeros((B, length + 1), dtype=torch.int32,
                          device=starts.device)
    valid = ends > starts
    if mask is not None:
        valid = valid & mask
    one = torch.ones_like(starts)
    markers = scatter1_add(markers, starts, one, valid)
    markers = scatter1_add(markers, ends, -one, valid)
    return torch.cumsum(markers[:, :length], 1) > 0


def region_index(length: int, starts: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, length) int32: the number of region starts at or before each
    position, minus one (the index of the region it belongs to, regions
    ordered by start)."""
    B = starts.shape[0]
    markers = torch.zeros((B, length + 1), dtype=torch.int32,
                          device=starts.device)
    ok = mask if mask is not None else torch.ones_like(starts,
                                                        dtype=torch.bool)
    markers = scatter1_add(markers, starts, torch.ones_like(starts), ok)
    return (torch.cumsum(markers[:, :length], 1) - 1).to(torch.int32)


def ff_run_length(x: torch.Tensor, value: int = 0xFF) -> torch.Tensor:
    """(B, N) uint8 -> (B, N) int32: the number of consecutive bytes equal
    to `value` starting at each position (a reverse cumulative minimum of
    the next other byte's position)."""
    B, N = x.shape
    pos = torch.arange(N, dtype=torch.int32, device=x.device).expand(B, N)
    non = torch.where(x != value, pos, torch.full_like(pos, N))
    nxt = torch.cummin(non.flip(1), 1).values.flip(1)
    return nxt - pos


def resolve_copy_chains(src: torch.Tensor, rounds: int) -> torch.Tensor:
    """Pointer-double src indices until they stop changing, at most
    `rounds` times: src[i] <- src[src[i]]."""
    for _ in range(rounds):
        nxt = take1(src, src)
        if torch.equal(nxt, src):
            break
        src = nxt
    return src
