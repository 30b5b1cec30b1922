"""Build and load the port's CUDA kernels.

The JAX package has no counterpart module: its Pallas kernels compile
inside `jax.jit` (libzseek_tpu/ops/pallas_match.py, pallas_entropy.py,
vector_entropy.py, pallas_decode.py, pallas_lz4.py).  Headers
(`csrc/*.cuh`) are hashed with the sources and included by them.

Route (b) of the port's kernel guide: every `csrc/*.cu` is compiled by
`nvcc -gencode arch=compute_90a,code=sm_90a -Xcompiler -fPIC -c`, one
nvcc per source, all started together, and the objects are linked into
ONE shared library with a plain C interface, loaded with ctypes.
The library lands in `build/torch_kernels/` at the repository root (a
gitignored directory), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing is
built at import: the first wrapper that launches a kernel calls
`library()`.

Each C entry point launches on the stream it is given, allocates nothing
and returns `cudaGetLastError()`; `check` raises on a non-zero code.  The
wrappers call them through `launch`, which makes the tensors' device the
calling thread's current one (the CUDA runtime launches there, and sets
a kernel's attributes there) and passes that device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    "zk_parse_linked": [_P] * 5 + [_I] * 11 + [_P] * 7,
    "zk_entropy_emit": [_P] * 8 + [_I] * 8 + [_P] * 8,
    "zk_vector_literals": [_P] * 5 + [_I] * 4 + [_P] * 5,
    "zk_decode": [_P] * 8 + [_I] * 7 + [_P] * 12,
    "zk_transcode": [_P] * 9 + [_I] * 5 + [_P] * 6,
    "zk_lz4_emit": [_P] * 3 + [_I] * 6 + [_P] * 4,
    "zk_lz4_decode": [_P] * 3 + [_I] * 6 + [_P] * 6 + [_I, _P],
    "zk_hash_parse": [_P] * 2 + [_I] * 4 + [_P] * 5,
    "zk_huf_lanes": [_P] * 6 + [_I] * 6 + [_P] * 3,
    "zk_fse_lanes": [_P] * 10 + [_I] * 6 + [_P] * 6,
    "zk_exec_blocks": [_P] * 7 + [_I] * 6 + [_P] * 10,
    "zk_greedy_select": [_P] * 4 + [_I] * 5 + [_P] * 5,
}
# entry points that return a size: the int32 words of scratch a launch of
# zk_entropy_emit (B, N, S) or zk_vector_literals (B, N) needs
SIZES = {
    "zk_entropy_scratch": [_I] * 3,
    "zk_vector_scratch": [_I] * 2,
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(os.path.basename(s).encode())
            with open(s, "rb") as f:
                h.update(f.read())
        so = os.path.join(BUILD_DIR,
                          f"libzseek_torch_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            nvcc = _nvcc()
            jobs = []
            for s in srcs:
                if s.endswith(".cu"):
                    obj = f"{tmp}.{os.path.basename(s)}.o"
                    jobs.append((obj, subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, s],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True)))
            errors = []
            for obj, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{obj}: nvcc {proc.returncode}\n{err}")
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
            res = subprocess.run([nvcc, "-shared", "-o", tmp,
                                  *[obj for obj, _ in jobs]],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
            for obj, _ in jobs:
                os.remove(obj)
        lib = ctypes.CDLL(so)
        for table, restype in ((SIGNATURES, ctypes.c_int),
                               (SIZES, ctypes.c_longlong)):
            for name, argtypes in table.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def launch(name: str, dev, *args) -> None:
    """Call C entry point `name` with `args` and the current stream of
    `dev` (the device of the launch's tensors), with `dev` the calling
    thread's current device; raise on a non-zero return."""
    import torch

    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
