"""Parallel bitstream packing.

Counterpart of libzseek_tpu/ops/bits.py (pack_bits_at :19, pack_bits :41,
close_stream_bits :51, words_to_bytes :58).  zstd's FSE and Huffman
streams are (value, nbits) emissions packed LSB-first; every emission
knows its absolute bit offset (a prefix sum over nbits), so packing is
one scatter of word contributions over disjoint bit ranges.  Word buffers
are int32 (the reference's uint32 words, same bits); rows are batched.
"""

from __future__ import annotations

import torch

from libzseek_tpu_torch.ops import common as C


def pack_bits_at(values: torch.Tensor, nbits: torch.Tensor,
                 bitpos: torch.Tensor, out_words: int) -> torch.Tensor:
    """(value, nbits) emissions at absolute bit offsets -> (B, out_words)
    int32 words.  Values are cut to nbits (at most 32); emissions with
    nbits 0 and bits past the buffer are dropped."""
    nb = nbits.to(torch.int64)
    mask = torch.where(nb >= 32, torch.full_like(nb, 0xFFFFFFFF),
                       (torch.ones_like(nb) << torch.clamp(nb, 0, 31)) - 1)
    live = (nb > 0) & (bitpos < 32 * out_words)
    return C.place_bits(values.to(torch.int64) & mask, bitpos, live,
                        out_words)


def pack_bits(values: torch.Tensor, nbits: torch.Tensor, out_words: int):
    """In-order emissions: bit offsets are the running sum of nbits.
    Returns (words (B, out_words) int32, total_bits (B,) int32)."""
    end = torch.cumsum(nbits, 1, dtype=torch.int64)
    return pack_bits_at(values, nbits, end - nbits, out_words), \
        end[:, -1].to(torch.int32)


def close_stream_bits(total_bits: torch.Tensor) -> torch.Tensor:
    """Byte length of a zstd bitstream closed by its one sentinel bit
    (BIT_closeCStream)."""
    return (total_bits + 1 + 7) >> 3


def words_to_bytes(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """(B, W) int32 words -> (B, n_bytes) uint8, little-endian."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 8, device=words.device)
    b = (w[:, :, None] >> shifts) & 0xFF
    return b.to(torch.uint8).reshape(words.shape[0], -1)[:, :n_bytes]
