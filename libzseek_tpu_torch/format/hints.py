"""Decode-hints sidecar: a skippable frame of bitstream anchors.

Copy of libzseek_tpu/format/hints.py: the anchor records, `serialize`
(the Writer's half) and `parse` (the Reader's half).  The encoder knows
every emission's absolute bit offset, so it publishes anchors (bit
position [, tANS states, rep1] every A symbols) into a skippable frame
appended before the seek table; stock zstd tooling skips it (0x184D2A5n
magic).  The port's Reader parses it for the lane decode route
(`ZstdCodec(decoder="lanes")`, ops/zstd_decode.py decode_frames_lanes),
which splits Huffman and FSE walks into anchored lanes; the fused route
walks whole streams and needs no anchors.  Archives stay byte-identical
to the JAX Writer's.

Layout (all little-endian), payload of skippable frame magic 0x184D2A5A:

  u32 version (=1)
  u32 frame_count
  per archive frame:
    u32 block_count
    per block:
      u8  kind: 0 = no hints, 1 = zstd compressed-block hints
      kind 1:
        u8  n_lit_streams (0, 1 or 4)
        u16 lit_interval A (symbols per anchor)
        per stream: u16 n_anchors, then n_anchors x u32 bit positions
                    (positions AFTER decoding k*A symbols, reading backward)
        u16 seq_interval, u16 n_seq_anchors
        per anchor: u32 bitpos, u16 s_ll, u16 s_of, u16 s_ml, u32 rep1
  u32 total size of the skippable frame (locates it from the seek table)
"""

from __future__ import annotations

import dataclasses
import struct

HINTS_MAGIC = 0x184D2A5A
VERSION = 1


@dataclasses.dataclass
class StreamAnchors:
    interval: int
    bitpos: list[list[int]]       # per stream: anchor bit positions


@dataclasses.dataclass
class SeqAnchors:
    interval: int
    bitpos: list[int]
    states: list[tuple[int, int, int]]   # (s_ll, s_of, s_ml) per anchor
    rep1: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BlockHints:
    lit: StreamAnchors | None = None
    seq: SeqAnchors | None = None


def serialize(frames: list[list[BlockHints | None]]) -> bytes:
    body = bytearray(struct.pack("<II", VERSION, len(frames)))
    for blocks in frames:
        body += struct.pack("<I", len(blocks))
        for bh in blocks:
            if bh is None or (bh.lit is None and bh.seq is None):
                body += b"\x00"
                continue
            body += b"\x01"
            lit = bh.lit or StreamAnchors(0, [])
            body += struct.pack("<BH", len(lit.bitpos), lit.interval)
            for stream in lit.bitpos:
                body += struct.pack("<H", len(stream))
                body += struct.pack(f"<{len(stream)}I", *stream)
            seq = bh.seq or SeqAnchors(0, [], [])
            body += struct.pack("<HH", seq.interval, len(seq.bitpos))
            rep1 = seq.rep1 or [1] * len(seq.bitpos)
            for bp, (sl, so, sm), r1 in zip(seq.bitpos, seq.states, rep1):
                body += struct.pack("<IHHHI", bp, sl, so, sm, r1)
    # trailing total size lets a reader locate the frame backward from
    # the seek table without scanning
    total = 8 + len(body) + 4
    body += struct.pack("<I", total)
    return struct.pack("<II", HINTS_MAGIC, len(body)) + bytes(body)


def parse(data: bytes, offset: int = 0) -> list[list[BlockHints | None]] | None:
    """Parse a hints skippable frame at `offset`; None if absent/foreign."""
    if len(data) - offset < 16:
        return None
    magic, size = struct.unpack_from("<II", data, offset)
    if magic != HINTS_MAGIC:
        return None
    pos = offset + 8
    end = pos + size
    try:
        version, nframes = struct.unpack_from("<II", data, pos)
        pos += 8
        if version != VERSION:
            return None
        frames = []
        for _ in range(nframes):
            (nblocks,) = struct.unpack_from("<I", data, pos)
            pos += 4
            blocks: list[BlockHints | None] = []
            for _ in range(nblocks):
                kind = data[pos]
                pos += 1
                if kind == 0:
                    blocks.append(None)
                    continue
                nstreams, lit_interval = struct.unpack_from("<BH", data, pos)
                pos += 3
                streams = []
                for _ in range(nstreams):
                    (cnt,) = struct.unpack_from("<H", data, pos)
                    pos += 2
                    streams.append(list(struct.unpack_from(f"<{cnt}I", data,
                                                           pos)))
                    pos += 4 * cnt
                seq_interval, nseq = struct.unpack_from("<HH", data, pos)
                pos += 4
                bps, states, rep1 = [], [], []
                for _ in range(nseq):
                    bp, sl, so, sm, r1 = struct.unpack_from("<IHHHI", data,
                                                            pos)
                    pos += 14
                    bps.append(bp)
                    states.append((sl, so, sm))
                    rep1.append(r1)
                lit = StreamAnchors(lit_interval, streams) if streams else None
                seq = (SeqAnchors(seq_interval, bps, states, rep1)
                       if seq_interval else None)
                blocks.append(BlockHints(lit, seq))
            frames.append(blocks)
        if pos > end:
            return None
        return frames
    except (struct.error, IndexError):
        return None
