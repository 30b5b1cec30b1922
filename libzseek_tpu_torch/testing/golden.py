"""Golden-reference codec bindings: the system libzstd and liblz4 through
ctypes.

Copy of libzseek_tpu/testing/golden.py (zstd and LZ4 halves; the zstd
encoder's worker and window knobs stay behind).  Used only by tests and
by chip_smoke.py as the format-conformance oracle: every archive the
port writes must decompress bit for bit through the stock libraries,
and archives they write must decode through the port's reader.  The
runtime has no dependency on it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

__all__ = ["have_zstd", "have_lz4", "zstd_compress", "zstd_decompress",
           "zstd_frame_decompress", "lz4f_compress", "lz4f_decompress",
           "lz4_block_compress", "lz4_block_decompress"]


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


@functools.cache
def _lz4():
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.LZ4F_isError.restype = ctypes.c_uint
    lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
    lib.LZ4F_getErrorName.restype = ctypes.c_char_p
    lib.LZ4F_getErrorName.argtypes = [ctypes.c_size_t]
    lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
    lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    lib.LZ4F_compressFrame.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_createDecompressionContext.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
    lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
    lib.LZ4F_decompress.restype = ctypes.c_size_t
    lib.LZ4F_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
    # raw block API (for testing block decoders in isolation)
    lib.LZ4_compressBound.restype = ctypes.c_int
    lib.LZ4_compressBound.argtypes = [ctypes.c_int]
    lib.LZ4_compress_default.restype = ctypes.c_int
    lib.LZ4_compress_default.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.LZ4_decompress_safe.restype = ctypes.c_int
    lib.LZ4_decompress_safe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


def have_zstd() -> bool:
    return _zstd() is not None


def have_lz4() -> bool:
    return _lz4() is not None


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


# --- LZ4F structures (lz4frame.h) ---
class LZ4F_frameInfo_t(ctypes.Structure):
    _fields_ = [
        ("blockSizeID", ctypes.c_int),
        ("blockMode", ctypes.c_int),
        ("contentChecksumFlag", ctypes.c_int),
        ("frameType", ctypes.c_int),
        ("contentSize", ctypes.c_ulonglong),
        ("dictID", ctypes.c_uint),
        ("blockChecksumFlag", ctypes.c_int),
    ]


class LZ4F_preferences_t(ctypes.Structure):
    _fields_ = [
        ("frameInfo", LZ4F_frameInfo_t),
        ("compressionLevel", ctypes.c_int),
        ("autoFlush", ctypes.c_uint),
        ("favorDecSpeed", ctypes.c_uint),
        ("reserved", ctypes.c_uint * 3),
    ]


LZ4F_max64KB = 4
LZ4F_blockLinked = 0
LZ4F_blockIndependent = 1


def lz4f_compress(data: bytes, level: int = 0,
                  block_size_id: int = LZ4F_max64KB,
                  content_size: bool = True,
                  block_independent: bool = False) -> bytes:
    """LZ4F_compressFrame with the reference writer's preferences
    (autoFlush=1, 64 KiB blocks; src/compress.c:204-207 of the reference
    library)."""
    lib = _lz4()
    prefs = LZ4F_preferences_t()
    prefs.compressionLevel = level
    prefs.autoFlush = 1
    prefs.frameInfo.blockSizeID = block_size_id
    prefs.frameInfo.blockMode = (LZ4F_blockIndependent if block_independent
                                 else LZ4F_blockLinked)
    if content_size:
        prefs.frameInfo.contentSize = len(data)
    bound = lib.LZ4F_compressFrameBound(len(data), ctypes.byref(prefs))
    dst = ctypes.create_string_buffer(bound)
    n = lib.LZ4F_compressFrame(dst, bound, data, len(data), ctypes.byref(prefs))
    if lib.LZ4F_isError(n):
        raise RuntimeError(lib.LZ4F_getErrorName(n).decode())
    return dst.raw[:n]


def lz4f_decompress(data: bytes) -> bytes:
    """Decompress a (possibly multi-frame, possibly skippable-frame-bearing)
    LZ4 frame stream, the way any stock LZ4F consumer reads our archives."""
    lib = _lz4()
    ctx = ctypes.c_void_p()
    ret = lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), 100)
    if lib.LZ4F_isError(ret):
        raise RuntimeError("LZ4F ctx creation failed")
    try:
        out = bytearray()
        src = ctypes.create_string_buffer(data, len(data))
        src_pos = 0
        chunk = 1 << 20
        out_mem = ctypes.create_string_buffer(chunk)
        while src_pos < len(data):
            src_size = ctypes.c_size_t(len(data) - src_pos)
            dst_size = ctypes.c_size_t(chunk)
            ret = lib.LZ4F_decompress(
                ctx, out_mem, ctypes.byref(dst_size),
                ctypes.byref(src, src_pos), ctypes.byref(src_size), None)
            if lib.LZ4F_isError(ret):
                raise RuntimeError(lib.LZ4F_getErrorName(ret).decode())
            out += out_mem.raw[: dst_size.value]
            if src_size.value == 0 and dst_size.value == 0:
                raise RuntimeError("LZ4F decompression stalled")
            src_pos += src_size.value
        return bytes(out)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)


def lz4_block_compress(data: bytes) -> bytes:
    lib = _lz4()
    bound = lib.LZ4_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = lib.LZ4_compress_default(data, dst, len(data), bound)
    if n <= 0:
        raise RuntimeError("LZ4_compress_default failed")
    return dst.raw[:n]


def lz4_block_decompress(data: bytes, dst_size: int) -> bytes:
    lib = _lz4()
    dst = ctypes.create_string_buffer(dst_size)
    n = lib.LZ4_decompress_safe(data, dst, len(data), dst_size)
    if n < 0:
        raise RuntimeError("LZ4_decompress_safe failed (corrupt block)")
    return dst.raw[:n]
