"""Pluggable IO boundary.

Parity with the reference's callback typedefs (zseek_write_t / zseek_pread_t
/ zseek_fsize_t and the zseek_write_file_t / zseek_read_file_t structs,
src/zseek.h:39-116 of the reference library): the writer calls DOWN into a user write
callback; the reader into pread/fsize callbacks — file, object store,
anything.  FileIO supplies the FILE*-based defaults
(src/compress.c:39-50, src/decompress.c:47-98).

Copy of libzseek_tpu/runtime/io.py.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Protocol


class WriteSink(Protocol):
    def write(self, data: bytes) -> None: ...


class ReadSource(Protocol):
    def pread(self, offset: int, size: int) -> bytes: ...
    def fsize(self) -> int: ...


class CallbackWriteSink:
    """Wraps a bare callable write(data) -> None (or -> bool)."""

    def __init__(self, fn: Callable[[bytes], object]):
        self._fn = fn

    def write(self, data: bytes) -> None:
        r = self._fn(data)
        if r is False:
            raise IOError("user write callback failed")


class CallbackReadSource:
    def __init__(self, pread: Callable[[int, int], bytes],
                 fsize: Callable[[], int]):
        self._pread = pread
        self._fsize = fsize

    def pread(self, offset: int, size: int) -> bytes:
        return self._pread(offset, size)

    def fsize(self) -> int:
        return self._fsize()


class FileIO:
    """Default file-backed IO (both directions)."""

    def __init__(self, f: io.RawIOBase | io.BufferedIOBase):
        self._f = f
        try:
            self._fd = f.fileno()
        except (AttributeError, OSError, io.UnsupportedOperation):
            self._fd = None

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def pread(self, offset: int, size: int) -> bytes:
        if self._fd is not None:
            return os.pread(self._fd, size, offset)
        self._f.seek(offset)
        return self._f.read(size)

    def fsize(self) -> int:
        if self._fd is not None:
            return os.fstat(self._fd).st_size
        pos = self._f.tell()
        self._f.seek(0, os.SEEK_END)
        n = self._f.tell()
        self._f.seek(pos)
        return n


class BytesIOSource:
    """In-memory archive source."""

    def __init__(self, data: bytes):
        self._data = data

    def pread(self, offset: int, size: int) -> bytes:
        return self._data[offset: offset + size]

    def fsize(self) -> int:
        return len(self._data)


class CountingSink:
    """Byte-counting sink, like the benchmark's counting_write callback
    (test/benchmark.c:139-151 of the reference library)."""

    def __init__(self, inner: WriteSink | None = None):
        self.inner = inner
        self.bytes_written = 0

    def write(self, data: bytes) -> None:
        self.bytes_written += len(data)
        if self.inner is not None:
            self.inner.write(data)
