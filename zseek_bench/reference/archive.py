"""The seekable archive, read the plain way: the seek table at the end
(the zstd seekable format, which libzseek writes for both codecs), a walk
over every frame's headers, and the plain decoders for whole frames."""

from __future__ import annotations

import struct

from zseek_bench.reference import lz4, zstd

SKIPPABLE_LO, SKIPPABLE_HI = 0x184D2A50, 0x184D2A5F
TABLE_MAGIC = 0x184D2A5E
FOOTER_MAGIC = 0x8F92EAB1


class ArchiveError(ValueError):
    pass


# what walking damaged bytes can raise besides ValueError: an index or a
# table key past its end, a struct read past the buffer
MALFORMED = (IndexError, KeyError, struct.error)


def seek_table(buf) -> list[tuple[int, int]]:
    """(compressed size, decompressed size) of each frame, in order."""
    n = len(buf)
    if n < 17:
        raise ArchiveError("archive too small for a seek table")
    frames, desc, magic = struct.unpack_from("<IBI", buf, n - 9)
    if magic != FOOTER_MAGIC or desc & 0x7C:
        raise ArchiveError("bad seek table footer")
    per = 12 if desc & 0x80 else 8
    size = 8 + per * frames + 9
    if size > n:
        raise ArchiveError("seek table larger than the archive")
    smagic, slen = struct.unpack_from("<II", buf, n - size)
    if smagic != TABLE_MAGIC or slen != size - 8:
        raise ArchiveError("bad seek table header")
    return [struct.unpack_from("<II", buf, n - size + 8 + per * i)
            for i in range(frames)]


def _zstd_walk(buf, pos: int) -> tuple[int, int | None]:
    """Offset past the zstd frame at pos, and its declared content size."""
    if struct.unpack_from("<I", buf, pos)[0] != zstd.MAGIC:
        raise ArchiveError("no zstd magic at a frame's start")
    fhd = buf[pos + 4]
    single, fcs_flag = (fhd >> 5) & 1, fhd >> 6
    did = (0, 1, 2, 4)[fhd & 3]
    q = pos + 5 + (not single) + did
    fcs_len = {0: int(single), 1: 2, 2: 4, 3: 8}[fcs_flag]
    size = None
    if fcs_len:
        size = int.from_bytes(buf[q: q + fcs_len], "little") + \
            (256 if fcs_len == 2 else 0)
    q += fcs_len
    while True:
        if q + 3 > len(buf):
            raise ArchiveError("zstd frame cut short")
        word = buf[q] | (buf[q + 1] << 8) | (buf[q + 2] << 16)
        btype, bsize = (word >> 1) & 3, word >> 3
        if btype == 3:
            raise ArchiveError("reserved block type")
        q += 3 + (1 if btype == 1 else bsize)
        if word & 1:
            break
    return q + 4 * ((fhd >> 2) & 1), size


def _lz4_walk(buf, pos: int) -> tuple[int, int | None]:
    if struct.unpack_from("<I", buf, pos)[0] != lz4.MAGIC:
        raise ArchiveError("no LZ4 magic at a frame's start")
    flg = buf[pos + 4]
    q = pos + 6
    size = None
    if flg & 8:
        size = struct.unpack_from("<Q", buf, q)[0]
        q += 8
    q += 4 * (flg & 1) + 1
    bsum = (flg >> 4) & 1
    while True:
        if q + 4 > len(buf):
            raise ArchiveError("LZ4 frame cut short")
        word = struct.unpack_from("<I", buf, q)[0]
        q += 4
        if word == 0:
            break
        q += (word & 0x7FFFFFFF) + 4 * bsum
    return q + 4 * ((flg >> 2) & 1), size


def structure(buf, codec: str) -> list[tuple[int, int, int]]:
    """Check the archive's layout: the seek table, each frame's headers
    against its entry (compressed size by walking its blocks, decompressed
    size by the frame header), and only skippable frames between the last
    frame and the table.  Returns (offset, compressed size, decompressed
    size) of each frame."""
    table = seek_table(buf)
    walk = _zstd_walk if codec == "zstd" else _lz4_walk
    frames = []
    pos = 0
    for c, d in table:
        end, size = walk(buf, pos)
        if end - pos != c:
            raise ArchiveError(f"frame at {pos}: {end - pos} bytes, the "
                               f"seek table says {c}")
        if size != d:
            raise ArchiveError(f"frame at {pos}: content size {size}, the "
                               f"seek table says {d}")
        frames.append((pos, c, d))
        pos = end
    tail = len(buf) - (8 + (12 if buf[-5] & 0x80 else 8) * len(table) + 9)
    while pos < tail:
        magic, n = struct.unpack_from("<II", buf, pos)
        if not SKIPPABLE_LO <= magic <= SKIPPABLE_HI:
            raise ArchiveError(f"unexpected bytes at {pos} before the seek "
                               "table")
        pos += 8 + n
    if pos != tail:
        raise ArchiveError("skippable frames overrun the seek table")
    return frames


def decode_frame(buf, offset: int, size: int, codec: str) -> bytes:
    """The content of the frame at buf[offset: offset + size].  A damaged
    frame raises ArchiveError (a ValueError), whatever the walk tripped
    on."""
    dec = zstd.decode_frame if codec == "zstd" else lz4.decode_frame
    try:
        out, end = dec(memoryview(buf)[offset: offset + size])
    except MALFORMED as e:
        raise ArchiveError(f"{type(e).__name__}: {e}") from e
    if end != size:
        raise ArchiveError("frame shorter than its seek table entry")
    return out
