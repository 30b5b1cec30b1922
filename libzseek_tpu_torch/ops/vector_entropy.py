"""K3: literal placement for literal-heavy 4-stream Huffman rows.

Counterpart of libzseek_tpu/ops/vector_entropy.py vector_literals
(:439): its XLA prep `_vector_prep` (:210), its Pallas kernel
`_place_kernel` (:60, the pallas_call at :135) and its post
`_vector_post` (:417).  The output equals K2's literal half
(ops/entropy.py) bit for bit on the rows it takes.

On the card the whole call is one fused CUDA route,
csrc/place_literals.cu over csrc/huf_place.cuh (the placement K2's
literal half shares): each row's literal ranks from a block scan of the
popcounts of its coverage bitmask, each literal's code, the suffix sums
of code lengths a stream (streams are emitted in reverse symbol order),
the sentinels, sizes and anchors, and every code placed without a
global atomic (a chunk's words merged in shared memory, the words two
chunks share by a fix-up pass).  The plain version for tensors
on the CPU is `vector_prep` (the prep in PyTorch ops) and
`entropy.place_plain`; testing/entropy_mirror.py mirrors the CUDA phases
in numpy for the tests.
"""

from __future__ import annotations

import threading

import torch

from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops import entropy as E

N_BLOCK = 131072     # rows are full 128 KiB blocks
VEC_MIN_LC = 4096    # rows with fewer literals stay on K2's scalar emitter

# The reference sums its anchor partials over 512-byte chunks and is exact
# only while no chunk meets two stream boundaries, i.e. while every stream
# holds at least 512 literals (sq = ceil(lc/4) >= 512).  Rows routed here
# must stay inside that contract for the two routes to agree.
assert VEC_MIN_LC // 4 >= E.LIT_ANCHOR_INTERVAL, VEC_MIN_LC

launches = 0
_count = threading.Lock()   # the zstd stream's worker pipelines launch at once


def vector_prep(x, lit_mask_words, codes_packed, lens, vec_row):
    """(val, pos, sent, sizes4, lanch) of the rows marked in vec_row."""
    B, N = x.shape
    dev = x.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    bits = (lit_mask_words[:, :, None] >> shifts[None, None, :]) & 1
    in_range = torch.arange(N, device=dev)[None, :] < lens[:, None]
    mask = (bits != 0).reshape(B, N) & in_range & vec_row[:, None]
    mi = mask.to(torch.int64)
    rank = C.exclusive_cumsum(mi, dim=1)
    lc = mi.sum(1)
    one = torch.zeros(B, dtype=torch.bool, device=dev)
    LMAXA, _ = E.anchor_slots(N, 1)
    return E.huf_layout(x, mask, rank, codes_packed, lc, one, LMAXA)


def vector_literals(x, lit_mask_words, codes_packed, lens, vec_row,
                    lit_cap: int):
    """4-stream Huffman literal payload of the rows marked in vec_row.

    x (B, 131072) uint8; lit_mask_words (B, N//32) int32 parse coverage
    bitmask (bit i of word w = byte 32w+i, 1 = literal); codes_packed
    (B, 256) int32 (value << 4) | nbits; lens (B,); vec_row (B,) bool.
    Returns (lit_words (B, lit_cap//4) int32, sizes4 (B, 4), lanch
    (B, 4, 64)), equal to K2's literal half on MODE_HUF 4-stream rows;
    other rows carry only their four sentinel bits."""
    B, N = x.shape
    if N != N_BLOCK:
        raise ValueError(f"vector literal rows are {N_BLOCK}-byte blocks")
    if lit_mask_words.shape != (B, N // 32) or codes_packed.shape != (B, 256):
        raise ValueError("lit_mask_words must be (B, N//32) and codes (B, 256)")
    if x.device.type == "cpu":
        val, pos, sent, sz, lanch = vector_prep(x, lit_mask_words,
                                                codes_packed, lens, vec_row)
        words = E.place_plain(val, pos, sent, lit_cap // 4)
        return words, sz.to(torch.int32), lanch.to(torch.int32)
    return _vector_cuda(x, lit_mask_words, codes_packed, lens, vec_row,
                        lit_cap // 4)


def _vector_cuda(x, lit_mask_words, codes_packed, lens, vec_row, LITW):
    global launches
    from libzseek_tpu_torch import kernels
    lib = kernels.library()
    dev = x.device
    B, N = x.shape
    LMAXA, _ = E.anchor_slots(N, 1)
    ins = [x.contiguous()] + [t.to(torch.int32).contiguous() for t in (
        lit_mask_words, codes_packed, lens)] + [vec_row.to(torch.bool)
                                                 .contiguous()]
    out = torch.empty((B, LITW), dtype=torch.int32, device=dev)
    sizes = torch.empty((B, 4), dtype=torch.int32, device=dev)
    lanch = torch.empty((B, 4, LMAXA), dtype=torch.int32, device=dev)
    tmp = torch.empty(lib.zk_vector_scratch(B, N), dtype=torch.int32,
                      device=dev)
    kernels.launch(
        "zk_vector_literals", dev, *[t.data_ptr() for t in ins], B, N, LITW,
        LMAXA, tmp.data_ptr(), out.data_ptr(), sizes.data_ptr(),
        lanch.data_ptr())
    with _count:
        launches += 1
    return out, sizes, lanch
