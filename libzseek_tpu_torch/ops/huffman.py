"""Huffman tree descriptions for zstd literals (RFC 8878 §4.2), read side.

Copy of read_weights and its FSE weight decoder from
libzseek_tpu/ops/huffman.py: the port's frame parser reads each block's
tree description into a weight vector; the decode tables themselves are
built on the device (ops/zstd_decode.build_dtabs).  The write side
serializes trees in the native library (zn_huf_tree_batch).

zstd conventions: weight = maxBits + 1 - codeLength for used symbols (0 =
unused); sum of 2^(weight-1) equals 2^maxBits; the last present symbol's
weight is implied.
"""

from __future__ import annotations

import numpy as np

from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import fse


def read_weights(data: bytes, offset: int) -> tuple[np.ndarray, int]:
    """Parse a Huffman tree description.  Returns (weights incl. the implied
    last symbol, bytes consumed)."""
    header = data[offset]
    if header >= 128:
        num = header - 127
        weights = np.zeros(num, np.int32)
        for i in range(num):
            b = data[offset + 1 + i // 2]
            weights[i] = (b >> 4) if i % 2 == 0 else (b & 0xF)
        consumed = 1 + (num + 1) // 2
    else:
        comp_size = header
        norm, table_log, used = fse.read_norm_counts(data, offset + 1, 255)
        dt = fse.build_decode_table(norm, table_log)
        stream = data[offset + 1 + used: offset + 1 + comp_size]
        weights = _fse_decode_interleaved(stream, dt)
        consumed = 1 + comp_size
    # implied last weight: complete sum to next power of two
    total = int(np.sum(np.where(weights > 0, 1 << (weights - 1), 0)))
    if total == 0:
        raise FormatError("empty huffman weights")
    max_bits = int(np.ceil(np.log2(total + 1)))
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise FormatError("invalid huffman weight sum")
    last_w = int(np.log2(rest)) + 1
    weights = np.append(weights, np.int32(last_w))
    return weights, consumed


def _fse_decode_interleaved(stream: bytes, dt: fse.DecodeTable) -> np.ndarray:
    """Decode an FSE-compressed huffman-weight stream (2 states, read
    backward from the sentinel bit; reads past the start give zeros)."""
    if not stream:
        raise FormatError("empty FSE weight stream")
    last = stream[-1]
    if last == 0:
        raise FormatError("corrupt FSE weight stream (zero last byte)")
    pos = 8 * (len(stream) - 1) + last.bit_length() - 1  # bits left
    val = int.from_bytes(stream, "little")

    def read(nb):
        nonlocal pos
        if nb == 0:
            return 0
        pos -= nb
        if pos < 0:
            return 0
        return (val >> pos) & ((1 << nb) - 1)

    tl = dt.table_log
    s1 = read(tl)
    s2 = read(tl)
    out = []
    while True:
        out.append(int(dt.symbol[s1]))
        nb = int(dt.nb_bits[s1])
        if pos < nb:
            # stream exhausted on state1: flush both
            s1 = int(dt.new_state[s1]) + read(nb)
            out.append(int(dt.symbol[s2]))
            break
        s1 = int(dt.new_state[s1]) + read(nb)
        out.append(int(dt.symbol[s2]))
        nb = int(dt.nb_bits[s2])
        if pos < nb:
            s2 = int(dt.new_state[s2]) + read(nb)
            out.append(int(dt.symbol[s1]))
            break
        s2 = int(dt.new_state[s2]) + read(nb)
    return np.array(out, np.int32)
