"""FSE (tANS) tables per RFC 8878 §4.1: construction and (de)serialization,
in numpy on the host.

Copy of the parts of libzseek_tpu/ops/fse.py that the port uses: the
write path builds encode tables (build_encode_table, for the entropy
kernel's constant tables) and serializes normalized counts
(write_norm_counts); the read path parses them (read_norm_counts) and
builds decode tables (build_decode_table, DecodeTable).  Tables hold at
most 2^9 states and are built once per distinct table of a batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from libzseek_tpu_torch.errors import FormatError


def _highbit(v: int) -> int:
    return v.bit_length() - 1


def spread_symbols(norm: np.ndarray, table_log: int) -> np.ndarray:
    """Symbol spread over the state table (RFC 8878 §4.1.1): low-prob (-1)
    symbols take states from the top; others interleave with the step."""
    table_size = 1 << table_log
    table = np.zeros(table_size, np.int32)
    high_threshold = table_size - 1
    for s, c in enumerate(norm):
        if c == -1:
            table[high_threshold] = s
            high_threshold -= 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(0, int(c))):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high_threshold:
                pos = (pos + step) & mask
    if pos != 0:
        raise FormatError("FSE spread did not cycle back to 0 (bad counts)")
    return table


@dataclasses.dataclass
class EncodeTable:
    table_log: int
    # per-state next-state table (indexed by cumulative rank)
    state_table: np.ndarray          # (table_size,) uint16-valued int32
    delta_nb_bits: np.ndarray        # (num_symbols,) int32
    delta_find_state: np.ndarray     # (num_symbols,) int32


def build_encode_table(norm: np.ndarray, table_log: int) -> EncodeTable:
    """FSE_buildCTable equivalent."""
    table_size = 1 << table_log
    num_sym = len(norm)
    spread = spread_symbols(norm, table_log)
    # cumulative symbol start positions
    cumul = np.zeros(num_sym + 1, np.int32)
    acc = 0
    for s, c in enumerate(norm):
        cumul[s] = acc
        acc += 1 if c == -1 else max(0, int(c))
    cumul[num_sym] = acc
    # state table: for each table cell (in spread order), record tableSize+u
    state_table = np.zeros(table_size, np.int32)
    cursor = cumul.copy()
    for u in range(table_size):
        s = spread[u]
        state_table[cursor[s]] = table_size + u
        cursor[s] += 1
    # per-symbol transition parameters
    delta_nb = np.zeros(num_sym, np.int32)
    delta_fs = np.zeros(num_sym, np.int32)
    total = 0
    for s, c in enumerate(norm):
        c = int(c)
        if c == 0:
            delta_nb[s] = ((table_log + 1) << 16) - table_size
            delta_fs[s] = 0
        elif c in (-1, 1):
            delta_nb[s] = (table_log << 16) - table_size
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits_out = table_log - _highbit(c - 1)
            min_state_plus = c << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_fs[s] = total - c
            total += c
    return EncodeTable(table_log, state_table, delta_nb, delta_fs)


@dataclasses.dataclass
class DecodeTable:
    table_log: int
    symbol: np.ndarray      # (table_size,) int32
    nb_bits: np.ndarray     # (table_size,) int32
    new_state: np.ndarray   # (table_size,) int32  (base; add read bits)


def build_decode_table(norm: np.ndarray, table_log: int) -> DecodeTable:
    """FSE_buildDTable equivalent."""
    table_size = 1 << table_log
    spread = spread_symbols(norm, table_log)
    symbol_next = np.array([1 if c == -1 else max(0, int(c)) for c in norm],
                           np.int32)
    nb_bits = np.zeros(table_size, np.int32)
    new_state = np.zeros(table_size, np.int32)
    for u in range(table_size):
        s = spread[u]
        nxt = symbol_next[s]
        symbol_next[s] += 1
        nb = table_log - _highbit(int(nxt))
        nb_bits[u] = nb
        new_state[u] = (int(nxt) << nb) - table_size
    return DecodeTable(table_log, spread.astype(np.int32), nb_bits, new_state)


# --- normalized-count (de)serialization, RFC 8878 §4.1.1 ---

def write_norm_counts(norm: np.ndarray, table_log: int) -> bytes:
    """FSE table description bitstream (FSE_writeNCount equivalent).

    Per count: value = count+1 (-1 encodes "less than 1"); values in
    [0, max) use nbBits-1 bits, [max, threshold) use nbBits bits as-is, and
    [threshold, ..] use nbBits bits shifted up by max.  A zero count is
    followed by 2-bit repeat flags covering subsequent zeros (3 = three more
    zeros, chained)."""
    bits: list[tuple[int, int]] = [(table_log - 5, 4)]
    remaining = (1 << table_log) + 1
    i = 0
    while remaining > 1 and i < len(norm):
        c = int(norm[i])
        i += 1
        threshold = 1 << _highbit(remaining)
        nb = _highbit(remaining) + 1
        mx = (1 << nb) - 1 - remaining
        value = c + 1
        if value >= threshold:
            value += mx
        if value < mx:
            bits.append((value, nb - 1))
        else:
            bits.append((value, nb))
        remaining -= 1 if c == -1 else abs(c)
        if c == 0:
            # repeat flags for runs of zeros
            zeros = 0
            while i + zeros < len(norm) and norm[i + zeros] == 0:
                zeros += 1
            while zeros >= 3:
                bits.append((3, 2))
                zeros -= 3
                i += 3
            bits.append((zeros, 2))
            i += zeros
    out = bytearray()
    acc = 0
    nacc = 0
    for v, nb in bits:
        acc |= (v & ((1 << nb) - 1)) << nacc
        nacc += nb
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def read_norm_counts(data: bytes, offset: int, max_symbol: int
                     ) -> tuple[np.ndarray, int, int]:
    """Parse an FSE table description (FSE_readNCount equivalent).
    Returns (norm, table_log, bytes_consumed)."""
    bitpos = 0

    def read(nb):
        nonlocal bitpos
        byte0 = offset + (bitpos >> 3)
        chunk = int.from_bytes(data[byte0: byte0 + 8], "little")
        v = (chunk >> (bitpos & 7)) & ((1 << nb) - 1)
        bitpos += nb
        return v

    table_log = read(4) + 5
    if table_log > 12:
        raise FormatError(f"FSE accuracy log {table_log} too large")
    remaining = (1 << table_log) + 1
    norm: list[int] = []
    while remaining > 1:
        if len(norm) > max_symbol + 1:
            raise FormatError("FSE description overruns symbol space")
        threshold = 1 << _highbit(remaining)
        nb = _highbit(remaining) + 1
        mx = (1 << nb) - 1 - remaining
        low = read(nb - 1)
        if low < mx:
            value = low
        else:
            extra = read(1)
            full = low | (extra << (nb - 1))
            value = full if full < threshold else full - mx
        c = value - 1
        norm.append(c)
        remaining -= 1 if c == -1 else abs(c)
        if c == 0 and remaining > 1:
            while True:
                rep = read(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
    consumed = (bitpos + 7) >> 3
    if remaining != 1:
        raise FormatError("FSE normalized counts do not sum to table size")
    return np.array(norm, np.int32), table_log, consumed
