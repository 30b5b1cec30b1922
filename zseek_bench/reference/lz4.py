"""A plain LZ4 frame decoder (LZ4 Frame Format 1.6 and the LZ4 block
format), written from the format's text and sharing nothing with the
port.  Linked and independent blocks, stored blocks, the optional block
and content checksums.  A malformed frame raises `LZ4Error`."""

from __future__ import annotations

from zseek_bench.reference.xxhash import xxh32

MAGIC = 0x184D2204
BLOCK_MAX = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


class LZ4Error(ValueError):
    pass


def decode_block(src, out: bytearray, start: int) -> None:
    """Append one LZ4 block's output to `out`; matches reach back no
    further than `start` (the frame's first byte)."""
    i, n = 0, len(src)
    while True:
        if i >= n:
            raise LZ4Error("block ends without its last literals")
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                if i >= n:
                    raise LZ4Error("literal length cut short")
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        if i + ll > n:
            raise LZ4Error("literals past the block")
        out += src[i: i + ll]
        i += ll
        if i == n:
            return
        if i + 2 > n:
            raise LZ4Error("offset cut short")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                if i >= n:
                    raise LZ4Error("match length cut short")
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        if off == 0 or off > len(out) - start:
            raise LZ4Error("offset out of the frame")
        s = len(out) - off
        if ml <= off:
            out += out[s: s + ml]
        else:
            pat = out[s:]
            out += (pat * (ml // off + 1))[:ml]


def decode_frame(buf, pos: int = 0) -> tuple[bytes, int]:
    """The LZ4 frame at buf[pos:]: (its content, the offset past it)."""
    buf = memoryview(buf).cast("B")
    if len(buf) - pos < 7 or int.from_bytes(buf[pos: pos + 4],
                                            "little") != MAGIC:
        raise LZ4Error("no LZ4 frame magic")
    flg, bd = buf[pos + 4], buf[pos + 5]
    if flg >> 6 != 1 or flg & 2 or bd & 0x8F:
        raise LZ4Error("bad frame descriptor")
    indep, bsum, has_size, csum, has_dict = (flg >> 5) & 1, (flg >> 4) & 1, \
        (flg >> 3) & 1, (flg >> 2) & 1, flg & 1
    bmax_id = (bd >> 4) & 7
    if bmax_id not in BLOCK_MAX:
        raise LZ4Error("bad block maximum")
    q = pos + 6
    size = None
    if has_size:
        size = int.from_bytes(buf[q: q + 8], "little")
        q += 8
    if has_dict:
        raise LZ4Error("dictionaries are not used here")
    if (xxh32(bytes(buf[pos + 4: q])) >> 8) & 0xFF != buf[q]:
        raise LZ4Error("header check byte differs")
    q += 1
    out = bytearray()
    while True:
        if q + 4 > len(buf):
            raise LZ4Error("frame cut short")
        word = int.from_bytes(buf[q: q + 4], "little")
        q += 4
        if word == 0:
            break
        stored, bsize = word >> 31, word & 0x7FFFFFFF
        if bsize > BLOCK_MAX[bmax_id] or q + bsize > len(buf):
            raise LZ4Error("block out of bounds")
        block = buf[q: q + bsize]
        if bsum:
            want = int.from_bytes(buf[q + bsize: q + bsize + 4], "little")
            if xxh32(bytes(block)) != want:
                raise LZ4Error("block checksum differs")
        before = len(out)
        if stored:
            out += block
        else:
            decode_block(block, out, before if indep else 0)
        if len(out) - before > BLOCK_MAX[bmax_id]:
            raise LZ4Error("block over the block maximum")
        q += bsize + 4 * bsum
    if csum:
        want = int.from_bytes(buf[q: q + 4], "little")
        if xxh32(bytes(out)) != want:
            raise LZ4Error("content checksum differs")
        q += 4
    if size is not None and size != len(out):
        raise LZ4Error("content size differs from the header")
    return bytes(out), q
