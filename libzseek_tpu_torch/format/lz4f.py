"""LZ4 frame format (LZ4F) container: headers, block framing, parsing.

Copy of libzseek_tpu/format/lz4f.py.  Spec: LZ4 Frame Format v1.6.x.  The
reference library emits one LZ4F frame per zseek frame through
LZ4F_compressFrame with autoFlush=1 and 64 KiB blocks (src/compress.c:
203-207, 737-786 of the reference library).  The port's LZ4 codec emits
the same shape (magic, FLG/BD/HC header with the content size, 64 KiB
blocks, end mark), linked by default; the parser reads linked and
independent frames, so archives of stock liblz4 stay readable.
"""

from __future__ import annotations

import dataclasses
import struct

from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.format.xxhash import xxh32

LZ4F_MAGIC = 0x184D2204

BLOCK_MAX = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}
UNCOMPRESSED_BIT = 0x80000000


@dataclasses.dataclass
class FrameInfo:
    block_size_id: int = 4          # 64 KiB, like the reference
    block_independent: bool = True
    content_checksum: bool = False
    block_checksums: bool = False
    content_size: int | None = None
    dict_id: int | None = None
    header_size: int = 0

    @property
    def block_max_size(self) -> int:
        return BLOCK_MAX[self.block_size_id]


def build_frame_header(content_size: int | None, block_size_id: int = 4,
                       block_independent: bool = True) -> bytes:
    flg = (1 << 6)  # version 01
    if block_independent:
        flg |= 1 << 5
    if content_size is not None:
        flg |= 1 << 3
    bd = block_size_id << 4
    body = bytes([flg, bd])
    if content_size is not None:
        body += struct.pack("<Q", content_size)
    hc = (xxh32(body) >> 8) & 0xFF
    return struct.pack("<I", LZ4F_MAGIC) + body + bytes([hc])


def parse_frame_header(data: bytes, offset: int = 0) -> FrameInfo:
    if len(data) - offset < 7:
        raise FormatError("truncated LZ4F frame header")
    magic = struct.unpack_from("<I", data, offset)[0]
    if magic != LZ4F_MAGIC:
        raise FormatError(f"bad LZ4F magic 0x{magic:08X}")
    flg = data[offset + 4]
    bd = data[offset + 5]
    if (flg >> 6) != 1:
        raise FormatError(f"unsupported LZ4F version {flg >> 6}")
    if flg & 0x02:
        raise FormatError("reserved FLG bit set")
    info = FrameInfo(
        block_size_id=(bd >> 4) & 0x7,
        block_independent=bool(flg & (1 << 5)),
        content_checksum=bool(flg & (1 << 2)),
        block_checksums=bool(flg & (1 << 4)),
    )
    if info.block_size_id not in BLOCK_MAX:
        raise FormatError(f"invalid block size id {info.block_size_id}")
    pos = offset + 6
    if flg & (1 << 3):
        info.content_size = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
    if flg & 0x01:
        info.dict_id = struct.unpack_from("<I", data, pos)[0]
        pos += 4
    hc = data[pos]
    pos += 1
    expect = (xxh32(bytes(data[offset + 4: pos - 1])) >> 8) & 0xFF
    if hc != expect:
        raise FormatError("LZ4F header checksum mismatch")
    info.header_size = pos - offset
    return info


@dataclasses.dataclass
class Block:
    offset: int          # file offset of block payload
    size: int            # payload size (without checksum)
    uncompressed: bool


def parse_blocks(data: bytes, info: FrameInfo,
                 start: int) -> tuple[list[Block], int]:
    """Walk the block chain from `start` (after the header) to the end mark.
    Returns (blocks, offset_after_frame)."""
    blocks: list[Block] = []
    pos = start
    n = len(data)
    while True:
        if pos + 4 > n:
            raise FormatError("truncated LZ4F block header")
        word = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if word == 0:  # EndMark
            break
        size = word & ~UNCOMPRESSED_BIT
        if size > info.block_max_size:
            raise FormatError("LZ4F block larger than declared maximum")
        if pos + size > n:
            raise FormatError("truncated LZ4F block payload")
        blocks.append(Block(pos, size, bool(word & UNCOMPRESSED_BIT)))
        pos += size
        if info.block_checksums:
            pos += 4
    if info.content_checksum:
        pos += 4
    return blocks, pos


def assemble_frame(blocks: list[tuple[bytes, bool]], content_size: int,
                   block_size_id: int = 4,
                   block_independent: bool = True) -> bytes:
    """Assemble an LZ4F frame from (payload, uncompressed) pairs."""
    out = bytearray(build_frame_header(content_size, block_size_id,
                                       block_independent))
    for payload, uncompressed in blocks:
        word = len(payload) | (UNCOMPRESSED_BIT if uncompressed else 0)
        out += struct.pack("<I", word)
        out += payload
    out += struct.pack("<I", 0)
    return bytes(out)
