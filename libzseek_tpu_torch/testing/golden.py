"""Golden-reference zstd bindings: the system libzstd through ctypes.

Copy of the zstd half of libzseek_tpu/testing/golden.py (the LZ4 half
waits for the port's LZ4 codec, ROADMAP A8).  Used only by tests and by
chip_smoke.py as the format-conformance oracle: every archive the port
writes must decompress bit for bit through stock libzstd, and archives
stock libzstd writes must decode through the port's reader.  The
runtime has no dependency on it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

__all__ = ["have_zstd", "zstd_compress", "zstd_decompress",
           "zstd_frame_decompress"]


@functools.cache
def _zstd():
    for name in ("libzstd.so.1", "libzstd.so", ctypes.util.find_library("zstd")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_createDCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressDCtx.restype = ctypes.c_size_t
    lib.ZSTD_decompressDCtx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def have_zstd() -> bool:
    return _zstd() is not None


# --- zstd parameter enums (zstd.h, stable since 1.4) ---
ZSTD_c_compressionLevel = 100
ZSTD_c_strategy = 107
ZSTD_fast = 1


def zstd_compress(data: bytes, level: int = 3,
                  strategy: int | None = ZSTD_fast) -> bytes:
    """Compress one zstd frame like the reference writer's defaults
    (level 3, strategy=ZSTD_fast; src/compress.c:58-90 of the reference
    library); strategy=None keeps the level's own strategy and window."""
    lib = _zstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        lib.ZSTD_CCtx_setParameter(cctx, ZSTD_c_compressionLevel, level)
        if strategy is not None:
            lib.ZSTD_CCtx_setParameter(cctx, ZSTD_c_strategy, strategy)
        bound = lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(bound)
        n = lib.ZSTD_compress2(cctx, dst, bound, data, len(data))
        if lib.ZSTD_isError(n):
            raise RuntimeError(lib.ZSTD_getErrorName(n).decode())
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def zstd_frame_decompress(data: bytes, dst_size: int) -> bytes:
    """Decompress a single zstd frame of known decompressed size."""
    lib = _zstd()
    dctx = lib.ZSTD_createDCtx()
    try:
        dst = ctypes.create_string_buffer(dst_size)
        n = lib.ZSTD_decompressDCtx(dctx, dst, dst_size, data, len(data))
        if lib.ZSTD_isError(n):
            raise RuntimeError(lib.ZSTD_getErrorName(n).decode())
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeDCtx(dctx)


class _ZSTD_Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def zstd_decompress(data: bytes) -> bytes:
    """Streaming-decompress a possibly multi-frame archive; skippable frames
    (the seek table, the hints sidecar) are skipped, exactly how any stock
    zstd consumer reads one of our archives."""
    lib = _zstd()
    ds = lib.ZSTD_createDStream()
    try:
        src_buf = ctypes.create_string_buffer(data, len(data))
        inb = _ZSTD_Buffer(ctypes.cast(src_buf, ctypes.c_void_p), len(data), 0)
        chunk = 1 << 20
        out_mem = ctypes.create_string_buffer(chunk)
        out = bytearray()
        while inb.pos < inb.size:
            outb = _ZSTD_Buffer(ctypes.cast(out_mem, ctypes.c_void_p), chunk, 0)
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise RuntimeError(lib.ZSTD_getErrorName(ret).decode())
            out += out_mem.raw[: outb.pos]
            if outb.pos == 0 and ret == 0 and inb.pos == inb.size:
                break
        return bytes(out)
    finally:
        lib.ZSTD_freeDStream(ds)
