"""Damaged zstd frames for the decoders' failure paths, and variants of
the lane decoders' calls (the port's tests and chip_smoke.py).

The port's own: each copy has one bit flipped near the end of one
compressed block, where the sequence section's backward bitstream
starts, so its walk reads other states, lengths and offsets and fails
at some sequence of the block (an offset past the bytes produced,
literals past the section, output past the frame, or bits left over),
or, where the host parse rejects the copy, never reaches a kernel."""

from __future__ import annotations

import numpy as np

from libzseek_tpu_torch.format import zstd_frame as zf


def compressed_blocks(frame: bytes) -> list[tuple[int, int]]:
    """(body offset, body size) of each compressed block of a frame."""
    pos = zf.parse_frame_header(frame, 0).header_size
    out = []
    while True:
        btype, size, last = zf.parse_block_header(frame, pos)
        if btype == zf.BLOCK_COMPRESSED:
            out.append((pos + 3, size))
        pos += 3 + (1 if btype == zf.BLOCK_RLE else size)
        if last:
            return out


def damaged_frames(frames, seed: int, n: int) -> list[tuple[int, bytes]]:
    """n damaged copies (index of the original, bytes) of frames with a
    compressed block of at least 16 bytes, cycling through them: one bit
    flipped in the last quarter of a random such block."""
    rng = np.random.default_rng(seed)
    usable = [(i, [b for b in compressed_blocks(f) if b[1] >= 16])
              for i, f in enumerate(frames)]
    usable = [(i, bl) for i, bl in usable if bl]
    out = []
    for j in range(n):
        i, blocks = usable[j % len(usable)]
        body, size = blocks[int(rng.integers(len(blocks)))]
        fr = bytearray(frames[i])
        p = body + size - 1 - int(rng.integers(max(size // 4, 1)))
        fr[p] ^= 1 << int(rng.integers(8))
        out.append((i, bytes(fr)))
    return out


def damaged_rows(args, seed: int, n: int):
    """n copies of K4's packed rows (ops/zstd_decode.k4_inputs, CPU
    tensors) with one bit of one row's sequence stream flipped, below the
    row's stream end (meta[12]): the walk fails at some sequence of the
    row, or decodes other values."""
    rng = np.random.default_rng(seed)
    sq, meta = args[1], args[4]
    bits = np.maximum(meta[:, 12].numpy().astype(np.int64), 0)
    out = []
    for _ in range(n):   # a row by its stream's length, then a bit of it
        r = int(np.searchsorted(np.cumsum(bits),
                                int(rng.integers(int(bits.sum()))),
                                side="right"))
        bit = int(rng.integers(int(bits[r])))
        s = sq.clone()
        s.view(-1)[r * s.shape[1] + bit // 32] ^= np.int32(
            np.uint32(1 << (bit % 32)).view(np.int32))
        out.append((args[0], s, *args[2:]))
    return out


def damaged_exec_rows(args, seed: int, n: int):
    """n copies of K6's inputs (ops/exec_blocks.execute_blocks: lit, ll,
    ml, off, meta, chain, frame_off, as CPU tensors), each with one field
    of one row changed, the kinds in turn: a sequence's literal or match
    length (the walk fails at that sequence, or writes other bytes), its
    offset (anywhere, also before the frame), the row's n_seq, its
    content, its d_off moved forward (a gap before it) or back so that
    it overlaps the row before (its frame no longer tiles in order)."""
    rng = np.random.default_rng(seed)
    meta = args[4].numpy()
    rows = np.nonzero(meta[:, 0] > 0)[0]
    out = []
    for i in range(n):
        r = int(rows[int(rng.integers(len(rows)))])
        j = int(rng.integers(int(meta[r, 0])))
        a = [t.clone() for t in args]
        kind = i % 7
        if kind < 2:
            a[1 + kind][r, j] += int(rng.integers(-3, 64))
        elif kind == 2:
            a[3][r, j] = int(rng.integers(-2, 3000))
        elif kind == 3:
            a[4][r, 0] += int(rng.integers(-2, 3))
        elif kind == 4:
            a[4][r, 1] += int(rng.integers(-20, 20))
        elif kind == 5:
            a[4][r, 2] += int(rng.integers(1, 300))
        else:
            a[4][r, 2] = max(0, int(meta[r, 2]) - int(rng.integers(1, 4096)))
        out.append(a)
    return out


# the per-lane arguments of ops/lanes.huf_lanes and seq_lanes
LANE_ARGS = ("sid", "bits", "n", "tid", "states", "rep1", "tids", "tls")


def lane_variants(kw: dict, seed: int, wide: int = 128 * 1024) -> dict:
    """Copies of one lane-decoder call's keyword arguments (CPU tensors;
    ops/lanes.huf_lanes or seq_lanes), by name: "damaged" (two bits
    flipped in each row of the bank, below its lanes' highest start),
    "shuffled" (the lanes in another order), "mixed tables" (the
    shuffled lanes, a third of them on other tables of the call), and
    "wide" (the bank's rows zero-padded to `wide` bytes, where that bank
    stays under 16 MiB)."""
    import torch
    rng = np.random.default_rng(seed)
    bank = kw["bank"]
    NS, SB = bank.shape
    out = {}
    dmg = bank.clone()
    sid = kw["sid"].clamp(0, NS - 1).numpy()
    top = np.zeros(NS, np.int64)
    np.maximum.at(top, sid, np.clip(kw["bits"].numpy(), 1, 8 * SB))
    for r in range(NS):
        for _ in range(2):
            b = int(rng.integers(max(int(top[r]), 1)))
            dmg[r, b >> 3] ^= 1 << (b & 7)
    out["damaged"] = dict(kw, bank=dmg)
    perm = torch.from_numpy(rng.permutation(len(sid)))
    shuf = {k: (v[perm].contiguous() if k in LANE_ARGS else v)
            for k, v in kw.items()}
    out["shuffled"] = shuf
    mixed = {k: (v.clone() if k in LANE_ARGS else v)
             for k, v in shuf.items()}
    k = len(sid) // 3
    key, tabs = ("tid", "dtabs") if "tid" in kw else ("tids", "tabs")
    T = kw[tabs].shape[0]
    mixed[key][:k] = torch.from_numpy(
        rng.integers(0, T, tuple(mixed[key][:k].shape)).astype(np.int32))
    out["mixed tables"] = mixed
    if SB < wide and NS * wide <= 16 << 20:
        w = torch.zeros((NS, wide), dtype=torch.uint8)
        w[:, :SB] = bank
        out["wide"] = dict(kw, bank=w)
    return out
