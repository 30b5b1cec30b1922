"""Damaged zstd frames for the decoders' failure paths, and variants of
the lane decoders' and K4's transcode arm's calls (the port's tests and
chip_smoke.py).

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


def transcode_variants(args, seed: int, n_damaged: int = 4) -> dict:
    """Copies of one call of K4's transcode arm (the positional arguments
    of ops/decode.transcode_blocks, CPU tensors), by name: "damaged i"
    (one bit of a row's sequence stream flipped, damaged_rows), "stopped"
    (offset code 40 in the OF entry a row's walk first reaches mid-row:
    the walk stops there), "wide" (a 12-bit state read in the LL entry of
    a row's last sequence, reached by no earlier step: a WIDE step that
    reads no state) and "shifted" (a chain's second row placed at byte 0
    of its frame: its offsets that reach before it fail) and "unstaged"
    (a row's stream moved above the row walk's 96 KiB stage: the same
    tokens, not consumed exactly).  A variant whose row cannot be found
    is left out."""
    import torch
    from libzseek_tpu_torch.ops import decode as D
    rng = np.random.default_rng(seed)
    out = {f"damaged {i}": a
           for i, a in enumerate(damaged_rows(args, seed, n_damaged))}
    sq, ft, meta, chain = (args[k].numpy() for k in (1, 3, 4, 5))
    rows = [r for r in rng.permutation(len(meta))
            if meta[r, 0] & D.DMODE_SEQ and meta[r, 13] >= 4]

    def trace(r):
        st = {"trace": []}
        D.tc_row_walk(sq[r], ft[r].tolist(), meta[r], int(meta[r, 2]), st)
        return st["trace"]

    def with_ftabs(r, k, s, entry):
        f = args[3].clone()
        f[r, k * 512 + s] = entry
        return (*args[:3], f, *args[4:])

    for r in rows:
        tr = trace(r)
        firsts = {}
        for t, (_, s_of, _) in enumerate(tr):
            firsts.setdefault(s_of, t)
        mid = [s for s, t in firsts.items() if 0 < t < len(tr) - 1]
        if mid:
            s = mid[int(rng.integers(len(mid)))]
            e = int(ft[r, 512 + s])
            out["stopped"] = with_ftabs(r, 1, s, (e & ~255) | 40)
            break
    for r in rows:
        tr = trace(r)
        last = tr[-1][0]
        if len(tr) == meta[r, 13] and all(st[0] != last for st in tr[:-1]):
            e = int(ft[r, last])
            out["wide"] = with_ftabs(r, 0, last, (e & ~(255 << 8)) | 12 << 8)
            break
    for c in range(len(chain) - 1):
        r = int(chain[c]) + 1
        if r < int(chain[c + 1]) and meta[r, 2] > 0:
            m = args[4].clone()
            m[r, 2] = 0
            out["shifted"] = (*args[:4], m, *args[5:])
            break
    if rows:
        # "unstaged": a row's stream moved up by `up` words past the row
        # walk's stage (96 KiB), zero words below it: the same tokens,
        # the walk ending `32 * up` bits above bit 0 (not exact)
        r, up = rows[0], 96 * 1024 // 4
        W = sq.shape[1]
        wide = np.zeros((len(sq), W + up), np.int32)
        wide[:, :W] = sq
        wide[r] = 0
        wide[r, up:] = sq[r]
        m = args[4].clone()
        m[r, 12] += 32 * up
        out["unstaged"] = (args[0], torch.from_numpy(wide), *args[2:4], m,
                           *args[5:])
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
