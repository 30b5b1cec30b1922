"""XXH32 and XXH64.

XXH32 is the LZ4 frame format's header checksum (the HC byte); XXH64 is
the zstd seekable format's per-frame checksum (the low 32 bits of XXH64
of the uncompressed frame, zstd contrib spec).

Copy of xxh32 and xxh64 from libzseek_tpu/format/xxhash.py: XXH32 in
pure Python (it hashes a few header bytes per frame), XXH64 computed by
the port's native host library (libzseek_tpu_torch/native, `zn_xxh64`).
"""

from __future__ import annotations

from libzseek_tpu_torch import native

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(v: int, lane: int) -> int:
    return (_rotl((v + lane * _P2) & _M32, 13) * _P1) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """Reference-exact XXH32 of a bytes-like object."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M32, (seed + _P2) & _M32, seed & _M32,
             (seed - _P1) & _M32]
        while i <= n - 16:
            for k in range(4):
                v[k] = _round(v[k], int.from_bytes(data[i + 4 * k:
                                                        i + 4 * k + 4],
                                                   "little"))
            i += 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        lane = int.from_bytes(data[i: i + 4], "little")
        h = (h + lane * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


def xxh64(data, seed: int = 0) -> int:
    """Reference-exact XXH64 of a bytes-like object."""
    return native.xxh64(data, seed)
