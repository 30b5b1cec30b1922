"""XXH32 and XXH64 in plain Python, from the xxHash specification: the
LZ4 frame header's check byte and the zstd content checksum."""

from __future__ import annotations

import struct

_M32, _M64 = (1 << 32) - 1, (1 << 64) - 1
P32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
P64 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
       9650029242287828579, 2870177450012600261)


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def xxh32(data: bytes, seed: int = 0) -> int:
    p1, p2, p3, p4, p5 = P32
    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + p1 + p2) & _M32, (seed + p2) & _M32, seed & _M32,
             (seed - p1) & _M32]
        while i + 16 <= n:
            for k, w in enumerate(struct.unpack_from("<4I", data, i)):
                v[k] = (_rotl32((v[k] + w * p2) & _M32, 13) * p1) & _M32
            i += 16
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12)
             + _rotl32(v[3], 18)) & _M32
    else:
        h = (seed + p5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (_rotl32((h + struct.unpack_from("<I", data, i)[0] * p3) & _M32,
                     17) * p4) & _M32
        i += 4
    while i < n:
        h = (_rotl32((h + data[i] * p5) & _M32, 11) * p1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * p2) & _M32
    h ^= h >> 13
    h = (h * p3) & _M32
    return h ^ (h >> 16)


def _round64(acc, w):
    return (_rotl64((acc + w * P64[1]) & _M64, 31) * P64[0]) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    p1, p2, p3, p4, p5 = P64
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + p1 + p2) & _M64, (seed + p2) & _M64, seed & _M64,
             (seed - p1) & _M64]
        while i + 32 <= n:
            for k, w in enumerate(struct.unpack_from("<4Q", data, i)):
                v[k] = _round64(v[k], w)
            i += 32
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round64(0, x)) * p1 + p4) & _M64
    else:
        h = (seed + p5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round64(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl64(h, 27) * p1 + p4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * p1) & _M64
        h = (_rotl64(h, 23) * p2 + p3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * p5) & _M64
        h = (_rotl64(h, 11) * p1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * p2) & _M64
    h ^= h >> 29
    h = (h * p3) & _M64
    return h ^ (h >> 32)
