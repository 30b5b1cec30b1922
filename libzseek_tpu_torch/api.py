"""Public API of the port: Writer/open_writer and Reader/open_reader.

Counterpart of libzseek_tpu/api.py open_writer (:75) and open_reader
(:93): the entry points build the port's own runtime Writer and Reader
(runtime/writer.py, runtime/reader.py, copies of the JAX package's)
around the port's ZstdCodec or LZ4Codec, so archives follow the same
format, byte for byte, and read back through the same seek-table logic.
"""

from __future__ import annotations

import io
from pathlib import Path

from libzseek_tpu_torch.runtime import writer as _writer
from libzseek_tpu_torch.runtime.io import FileIO
from libzseek_tpu_torch.runtime.reader import Reader

DEFAULT_MIN_FRAME_SIZE = _writer.DEFAULT_MIN_FRAME_SIZE


def Writer(sink, codec: str = "zstd", *, level: int | None = None,
           device: str = "cuda",
           min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
           batch_frames: int = 8, checksums: bool = False,
           owned_file=None) -> _writer.Writer:
    """Sequential seekable-archive writer with zstd or LZ4 frames
    (`codec` "zstd" or "lz4"; `level` None is the codec's default, 3 for
    zstd and 0 for LZ4) compressed on `device` ("cuda"; "cpu" runs the
    plain versions, for tests)."""
    return _writer.Writer(sink, codec, level=level, device=device,
                          min_frame_size=min_frame_size,
                          batch_frames=batch_frames, checksums=checksums,
                          owned_file=owned_file)


def open_writer(path_or_file, codec: str = "zstd", *,
                level: int | None = None, device: str = "cuda",
                min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
                batch_frames: int = 8,
                checksums: bool = False) -> _writer.Writer:
    """Writer on a path (opened and closed by the writer), a binary file
    object, or any sink with `write`."""
    kw = dict(codec=codec, level=level, device=device,
              min_frame_size=min_frame_size, batch_frames=batch_frames,
              checksums=checksums)
    if isinstance(path_or_file, (str, Path)):
        f = open(path_or_file, "wb")
        return Writer(FileIO(f), owned_file=f, **kw)
    if isinstance(path_or_file, io.IOBase):
        return Writer(FileIO(path_or_file), **kw)
    return Writer(path_or_file, **kw)


def open_reader(path_or_file, *, device: str = "cuda", cache_frames: int = 8,
                readahead: int = 8, verify_checksums: bool = False,
                device_cache: bool = False, decoder: str = "fused") -> Reader:
    """Reader on a path, a binary file object, or a pread/fsize source.
    A path's file stays open for the reader's lifetime.  `decoder` picks
    the zstd decode route ("fused", "lanes" or "transcode", Reader)."""
    kw = dict(device=device, cache_frames=cache_frames, readahead=readahead,
              verify_checksums=verify_checksums, device_cache=device_cache,
              decoder=decoder)
    if isinstance(path_or_file, (str, Path)):
        return Reader(FileIO(open(path_or_file, "rb")), **kw)
    if isinstance(path_or_file, io.IOBase):
        return Reader(FileIO(path_or_file), **kw)
    return Reader(path_or_file, **kw)
