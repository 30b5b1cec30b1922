"""zstd frame/block format (RFC 8878): headers, constants and the
literal-length and match-length code tables.

Copy of the parts of libzseek_tpu/format/zstd_frame.py that the port's
encode and decode chains use (the vectorised code helpers ll_code,
ml_code and of_code stay behind: the port computes codes with torch ops).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from libzseek_tpu_torch.errors import FormatError

ZSTD_MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17  # 128 KiB

BLOCK_RAW, BLOCK_RLE, BLOCK_COMPRESSED = 0, 1, 2

LIT_RAW, LIT_RLE, LIT_COMPRESSED, LIT_TREELESS = 0, 1, 2, 3

# --- predefined FSE distributions (RFC 8878 §3.1.1.3.2.2) ---
LL_DEFAULT_NORM = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
     -1, -1, -1, -1], np.int32)
LL_DEFAULT_LOG = 6
ML_DEFAULT_NORM = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
     -1, -1, -1, -1, -1], np.int32)
ML_DEFAULT_LOG = 6
OF_DEFAULT_NORM = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], np.int32)
OF_DEFAULT_LOG = 5

MAX_LL_CODE = 35
MAX_ML_CODE = 52
MAX_OF_CODE = 31  # format limit; predefined table covers 0..28

# --- literal-length code table: code -> (baseline, extra bits) ---
_LL_EXTRA = [0]*16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = np.array(_LL_EXTRA, np.int32)
LL_BASELINE = np.array(_LL_BASE, np.int32)

# --- match-length code table: code -> (baseline, extra bits) ---
_ML_EXTRA = [0]*32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = np.array(_ML_EXTRA, np.int32)
ML_BASELINE = np.array(_ML_BASE, np.int32)


@dataclasses.dataclass
class FrameHeader:
    content_size: int | None
    window_size: int
    single_segment: bool
    checksum: bool
    dict_id: int | None
    header_size: int


def build_frame_header(content_size: int, single_segment: bool = True,
                       checksum: bool = False) -> bytes:
    """Frame header with explicit content size.  Single-segment frames use
    window = content size (our frames are <= a few MiB)."""
    if content_size < 0:
        raise FormatError("negative content size")
    if single_segment:
        if content_size <= 255:
            fcs_flag, fcs_bytes = 0, 1
        elif content_size <= 65535 + 256:
            fcs_flag, fcs_bytes = 1, 2
        elif content_size < (1 << 32):
            fcs_flag, fcs_bytes = 2, 4
        else:
            fcs_flag, fcs_bytes = 3, 8
        fhd = (fcs_flag << 6) | (1 << 5) | (int(checksum) << 2)
        out = bytearray(struct.pack("<I", ZSTD_MAGIC))
        out.append(fhd)
        if fcs_flag == 0:
            out.append(content_size)
        elif fcs_flag == 1:
            out += struct.pack("<H", content_size - 256)
        elif fcs_flag == 2:
            out += struct.pack("<I", content_size)
        else:
            out += struct.pack("<Q", content_size)
        return bytes(out)
    raise NotImplementedError("windowed frames: encoder always single-segment")


def parse_frame_header(data, offset: int = 0) -> FrameHeader:
    if len(data) - offset < 6:
        raise FormatError("truncated zstd frame header")
    magic = struct.unpack_from("<I", data, offset)[0]
    if magic != ZSTD_MAGIC:
        raise FormatError(f"bad zstd magic 0x{magic:08X}")
    fhd = data[offset + 4]
    fcs_flag = fhd >> 6
    single = bool(fhd & (1 << 5))
    checksum = bool(fhd & (1 << 2))
    did_flag = fhd & 3
    if fhd & 0x08:
        raise FormatError("reserved frame-header bit set")
    pos = offset + 5
    window_size = 0
    if not single:
        wd = data[pos]
        pos += 1
        exponent, mantissa = wd >> 3, wd & 7
        base = 1 << (10 + exponent)
        window_size = base + (base // 8) * mantissa
    dict_id = None
    if did_flag:
        n = {1: 1, 2: 2, 3: 4}[did_flag]
        dict_id = int.from_bytes(data[pos: pos + n], "little")
        pos += n
    content_size = None
    if fcs_flag == 0:
        if single:
            content_size = data[pos]
            pos += 1
    elif fcs_flag == 1:
        content_size = struct.unpack_from("<H", data, pos)[0] + 256
        pos += 2
    elif fcs_flag == 2:
        content_size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
    else:
        content_size = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
    if single:
        window_size = content_size if content_size is not None else 0
    return FrameHeader(content_size, window_size, single, checksum, dict_id,
                       pos - offset)


def build_block_header(block_type: int, size: int, last: bool) -> bytes:
    word = int(last) | (block_type << 1) | (size << 3)
    return struct.pack("<I", word)[:3]


def parse_block_header(data, offset: int) -> tuple[int, int, bool]:
    if len(data) - offset < 3:
        raise FormatError("truncated block header")
    word = data[offset] | (data[offset + 1] << 8) | (data[offset + 2] << 16)
    last = bool(word & 1)
    btype = (word >> 1) & 3
    if btype == 3:
        raise FormatError("reserved block type")
    return btype, word >> 3, last
