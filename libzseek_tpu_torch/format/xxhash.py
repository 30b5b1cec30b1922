"""XXH64: the zstd seekable format's per-frame checksum is the low 32 bits
of XXH64 of the uncompressed frame (zstd contrib spec).

Copy of xxh64 from libzseek_tpu/format/xxhash.py, computed by the port's
native host library (libzseek_tpu_torch/native, `zn_xxh64`); the XXH32
half serves LZ4 frames, which the port does not write yet.
"""

from __future__ import annotations

from libzseek_tpu_torch import native


def xxh64(data, seed: int = 0) -> int:
    """Reference-exact XXH64 of a bytes-like object."""
    return native.xxh64(data, seed)
