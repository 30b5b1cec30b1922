"""The port's native host library (zn.cc beside this file), bound with
ctypes.

Counterpart of libzseek_tpu/native/__init__.py, cut to the entry points
the port calls and the seek table's seektable_serialize and
seektable_parse (:130-150), plus `gate_entropy` (the hash and sort
parsers' gate scale, which the reference computes on its device).
`zir_execute` and `huf_decode_batch` raise FormatError on corrupt input
where the reference's return -1 and None (its caller then falls back).
The library is built at first use
with `c++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off` (no fused
multiply-adds but the ones zn.cc writes) into `build/torch_native/` at the
repository root (a gitignored directory), named by a hash of the source
and flags, exactly as kernels/__init__.py builds the CUDA kernels: an
edited source rebuilds, an unchanged one loads at once, and concurrent
processes each link under a temporary name and rename into place.

Unlike the reference's loader, which probes for its .so on every call
until one appears (so a library built mid-session switches the codec's
long-distance pre-pass on between two runs), this one builds and loads
once per process, under a lock, and raises if the build fails: the
pre-pass changes the archive bytes, so the port never runs without it.
ctypes argtypes are always declared (a missing signature truncates
64-bit pointers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from libzseek_tpu_torch.errors import FormatError

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "zn.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_native")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """Build (if needed) and load the native library, once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            src = f.read()
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()
        so = os.path.join(BUILD_DIR, f"libzseek_torch_native_{h[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run(["c++", *CXX_FLAGS, "-o", tmp, SOURCE],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"building the native library failed "
                    f"({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.zn_huf_build_batch.argtypes = [u32p, ctypes.c_int, i32p, i32p,
                                           u8p, i32p, i32p]
        lib.zn_huf_build_batch.restype = None
        lib.zn_gate_entropy.argtypes = [i32p, ctypes.c_int, f32p]
        lib.zn_gate_entropy.restype = None
        lib.zn_huf_tree_batch.argtypes = [u8p, ctypes.c_int, u8p, i32p]
        lib.zn_huf_tree_batch.restype = None
        lib.zn_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_uint64]
        lib.zn_xxh64.restype = ctypes.c_uint64
        lib.zn_seektable_serialize.argtypes = [u32p, ctypes.c_int64, u8p]
        lib.zn_seektable_serialize.restype = ctypes.c_int64
        lib.zn_seektable_parse.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.zn_seektable_parse.restype = ctypes.c_int64
        lib.zn_ldm_scan.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                    i64p, i32p, ctypes.c_int64, i64p]
        lib.zn_ldm_scan.restype = ctypes.c_int64
        lib.zn_lz4_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64]
        lib.zn_lz4_decode.restype = ctypes.c_int64
        lib.zn_zir_execute.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.zn_zir_execute.restype = ctypes.c_int64
        lib.zn_huf_decode_batch.argtypes = [u8p, i64p, ctypes.c_int64, i32p,
                                            ctypes.c_int64, u8p, i64p]
        lib.zn_huf_decode_batch.restype = ctypes.c_int64
        _lib = lib
        return lib


def huf_build_batch(hists: np.ndarray):
    """hists: (nh, 256) uint32 -> (lengths (nh, 256) int32, codes (nh,
    256) int32, trees list[bytes | None], max_bits (nh,) int32).
    max_bits 0 = degenerate (< 2 symbols), -1 = unserializable tree."""
    lib = library()
    nh = hists.shape[0]
    hists = np.ascontiguousarray(hists, np.uint32)
    lengths = np.zeros((nh, 256), np.int32)
    codes = np.zeros((nh, 256), np.int32)
    trees = np.zeros((nh, 200), np.uint8)
    tree_lens = np.zeros(nh, np.int32)
    max_bits = np.zeros(nh, np.int32)
    lib.zn_huf_build_batch(hists.reshape(-1), nh, lengths.reshape(-1),
                           codes.reshape(-1), trees.reshape(-1), tree_lens,
                           max_bits)
    tree_list = [trees[i, : tree_lens[i]].tobytes() if max_bits[i] > 0
                 else None for i in range(nh)]
    return lengths, codes, tree_list, max_bits


def gate_entropy(hists: np.ndarray) -> np.ndarray:
    """(nh, 256) byte histograms -> (nh,) float32 entropy in bits, clipped
    to [1, 8], equal bit for bit to the reference's XLA computation on the
    CPU (zn.cc zn_gate_entropy)."""
    lib = library()
    hists = np.ascontiguousarray(hists, np.int32)
    out = np.zeros(hists.shape[0], np.float32)
    lib.zn_gate_entropy(hists.reshape(-1), hists.shape[0], out)
    return out


def huf_tree_batch(weights: np.ndarray) -> list[bytes | None]:
    """weights: (nh, 256) uint8 device-built zstd weights -> serialized
    tree descriptions (None where unserializable: the caller stores the
    block raw)."""
    lib = library()
    nh = weights.shape[0]
    weights = np.ascontiguousarray(weights, np.uint8)
    trees = np.zeros((nh, 200), np.uint8)
    tree_lens = np.zeros(nh, np.int32)
    lib.zn_huf_tree_batch(weights.reshape(-1), nh, trees.reshape(-1),
                          tree_lens)
    return [trees[i, : tree_lens[i]].tobytes() if tree_lens[i] > 0
            else None for i in range(nh)]


def xxh64(data, seed: int = 0) -> int:
    data = bytes(data)
    return int(library().zn_xxh64(data, len(data), seed))


def seektable_serialize(entries: np.ndarray) -> bytes:
    """entries (n, 2) uint32 (c_size, d_size) -> the serialized seek
    table's skippable frame (no checksums)."""
    n = entries.shape[0]
    entries = np.ascontiguousarray(entries, np.uint32)
    out = np.zeros(8 + 8 * n + 9, np.uint8)
    wrote = library().zn_seektable_serialize(entries.reshape(-1), n, out)
    return out[:wrote].tobytes()


def seektable_parse(table_frame: bytes):
    """The seek table's skippable-frame bytes (magic through footer) ->
    (n, cumulative (n+1, 2) int64 (c_off, d_off)), or None when they are
    malformed."""
    buf = np.ascontiguousarray(np.frombuffer(table_frame, np.uint8))
    max_n = max(1, (len(table_frame) - 17) // 8 + 1)
    cum = np.zeros((max_n + 1, 2), np.int64)
    n = library().zn_seektable_parse(buf, len(buf), cum.reshape(-1))
    if n < 0:
        return None
    return int(n), cum[: n + 1]


def ldm_scan(x: np.ndarray, nblocks: int, bsize: int,
             frame_base: np.ndarray, lens: np.ndarray,
             min_dist: int) -> np.ndarray:
    """Long-distance match scan over a batch (zn.cc zn_ldm_scan).
    x: concatenated block bytes (nblocks*bsize,); frame_base (nblocks,)
    int64 frame-start byte offsets (-1 = exclude); lens (nblocks,) int32.
    Returns (nblocks, 3) int64 rows [dist, span_start, span_end) — dist 0
    = no hit, [0, bsize) = whole-block match."""
    lib = library()
    x = np.ascontiguousarray(x, np.uint8)
    out = np.zeros((nblocks, 3), np.int64)
    lib.zn_ldm_scan(x, nblocks, bsize,
                    np.ascontiguousarray(frame_base, np.int64),
                    np.ascontiguousarray(lens, np.int32),
                    min_dist, out.reshape(-1))
    return out


def lz4_block_decode(src: np.ndarray, out: np.ndarray, base: int,
                     lo: int = 0) -> int:
    """Decode one LZ4 block into the uint8 frame buffer `out` at `base`;
    matches may reach back to byte `lo` (the frame start for linked
    blocks).  Returns the decompressed size, or -1 on corrupt input."""
    lib = library()
    src = np.ascontiguousarray(src, np.uint8)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a contiguous uint8 array")
    if not 0 <= lo <= base <= out.shape[0]:
        raise ValueError(f"need 0 <= lo <= base <= len(out), got lo={lo}, "
                         f"base={base}, len(out)={out.shape[0]}")
    return int(lib.zn_lz4_decode(src.ctypes.data, src.shape[0],
                                 out.ctypes.data, out.shape[0], base, lo))


def zir_execute(lits: np.ndarray, toks: np.ndarray, out: np.ndarray,
                base: int) -> int:
    """Expand one transcoded block (zn.cc zn_zir_execute, a copy of the
    reference's): its literal bytes `lits` (uint8) and packed sequence
    tokens `toks` (uint32, two words a sequence, K4's transcode arm) into
    the uint8 frame buffer `out` at byte `base`.  Returns the block's
    decompressed size; corrupt tokens raise FormatError."""
    lib = library()
    lits = np.ascontiguousarray(lits, np.uint8)
    toks = np.ascontiguousarray(toks, np.uint32)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a contiguous uint8 array")
    if toks.shape[0] % 2 or not 0 <= base <= out.shape[0]:
        raise ValueError(f"need an even token count and 0 <= base <= "
                         f"len(out), got {toks.shape[0]} tokens, base={base}")
    n = int(lib.zn_zir_execute(lits.ctypes.data, lits.shape[0],
                               toks.ctypes.data, toks.shape[0] // 2,
                               out.ctypes.data, out.shape[0], base))
    if n < 0:
        raise FormatError("corrupt sequences: a literal run, match offset "
                          "or match length leaves its block or frame")
    return n


def huf_decode_batch(streams: bytes, lane_meta: np.ndarray,
                     weights: np.ndarray, out_size: int,
                     out_off: np.ndarray) -> np.ndarray:
    """Huffman literal streams decoded on the host (zn.cc
    zn_huf_decode_batch, the reference's with its faults repaired).
    streams: the lanes' backward bitstreams concatenated; lane_meta (L, 4)
    int64 (stream offset, stream bytes, n_out, table id); weights (T, 256)
    int32 zstd weights; out_off (L,) int64 output byte offsets.  Returns
    the (out_size,) uint8 literal bytes; a malformed lane (a stream that
    runs dry or is not consumed exactly, a bad table) raises
    FormatError."""
    lib = library()
    lane_meta = np.ascontiguousarray(lane_meta, np.int64).reshape(-1, 4)
    weights = np.ascontiguousarray(weights, np.int32)
    out_off = np.ascontiguousarray(out_off, np.int64)
    if out_off.shape[0] != lane_meta.shape[0] or (
            len(lane_meta) and not (
                (lane_meta[:, 0] >= 0).all() and (lane_meta[:, 1] >= 0).all()
                and (lane_meta[:, 2] >= 0).all()
                and (lane_meta[:, 0] + lane_meta[:, 1] <= len(streams)).all()
                and (out_off >= 0).all()
                and (out_off + lane_meta[:, 2] <= out_size).all())):
        raise ValueError("lane_meta or out_off outside streams or out")
    out = np.zeros(max(1, out_size), np.uint8)
    sbuf = np.frombuffer(streams, np.uint8) if streams \
        else np.zeros(1, np.uint8)
    r = lib.zn_huf_decode_batch(np.ascontiguousarray(sbuf),
                                lane_meta.reshape(-1), lane_meta.shape[0],
                                weights.reshape(-1), weights.shape[0], out,
                                out_off)
    if r != lane_meta.shape[0]:
        raise FormatError(f"corrupt huffman literal stream (lane {-r - 1})")
    return out[:out_size]
