"""Public API of the port: Writer/open_writer and Reader/open_reader, the
per-algorithm parameter structs, and the C-API-shaped `zseek_*` shims.

Counterpart of libzseek_tpu/api.py: ZstdParams, LZ4Params and
CompressionParams (:46-72), open_writer (:75), open_reader (:93) and the
nine shims (:110-177), which mirror the reference library's exported
symbols (zseek.h:225-443):

    zseek_writer_open(file, ...)   -> Writer
    zseek_write(writer, buf)
    zseek_writer_close(writer)     -> WriterStats
    zseek_writer_stats(writer)
    zseek_reader_open(file, ...)   -> Reader
    zseek_pread(reader, size, offset)
    zseek_read(reader, size)
    zseek_reader_close(reader)
    zseek_reader_stats(reader)

The entry points build the port's own runtime Writer and Reader
(runtime/writer.py, runtime/reader.py, copies of the JAX package's)
around the port's ZstdCodec or LZ4Codec, so archives follow the same
format, byte for byte, and read back through the same seek-table logic.
Every entry point compresses or decodes on `device`, "cuda" by default
("cpu" runs the plain versions, for tests).  Errors raise ZseekError
subclasses.
"""

from __future__ import annotations

import dataclasses
import io
from pathlib import Path

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.runtime import writer as _writer
from libzseek_tpu_torch.runtime.io import FileIO
from libzseek_tpu_torch.runtime.reader import Reader
from libzseek_tpu_torch.runtime.stats import ReaderStats, WriterStats

DEFAULT_MIN_FRAME_SIZE = _writer.DEFAULT_MIN_FRAME_SIZE


# --- per-algorithm parameter structs (zseek.h:121-159) ---

@dataclasses.dataclass
class ZstdParams:
    """zseek_zstd_param_t (zseek.h:129-140).  nb_workers is the codec's
    `workers`; cpuset is accepted and ignored (device selection replaces
    CPU affinity); strategy folds into the level."""
    compression_level: int = 3
    nb_workers: int = 1
    strategy: int | None = None
    cpuset: object | None = None


@dataclasses.dataclass
class LZ4Params:
    """zseek_lz4_param_t (zseek.h:145-148)."""
    compression_level: int = 0
    nb_workers: int = 1


@dataclasses.dataclass
class CompressionParams:
    """zseek_compression_param_t (zseek.h:153-159): a tagged union of the
    per-algorithm structs."""
    type: str = "zstd"            # "zstd" | "lz4"
    zstd: ZstdParams | None = None
    lz4: LZ4Params | None = None


def Writer(sink, codec: str = "zstd", *, level: int | None = None,
           device: str = "cuda",
           min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
           batch_frames: int = 8, workers: int = 1, checksums: bool = False,
           owned_file=None) -> _writer.Writer:
    """Sequential seekable-archive writer with zstd or LZ4 frames
    (`codec` "zstd" or "lz4", or a codec object; `level` None is the
    codec's default, 3 for zstd and 0 for LZ4) compressed on `device`
    ("cuda"; "cpu" runs the plain versions, for tests)."""
    return _writer.Writer(sink, codec, level=level, device=device,
                          min_frame_size=min_frame_size,
                          batch_frames=batch_frames, workers=workers,
                          checksums=checksums, owned_file=owned_file)


def open_writer(path_or_file, codec: str = "zstd", *,
                level: int | None = None, device: str = "cuda",
                min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
                batch_frames: int = 8, workers: int = 1,
                checksums: bool = False) -> _writer.Writer:
    """Writer on a path (opened and closed by the writer), a binary file
    object, or any sink with `write`."""
    kw = dict(codec=codec, level=level, device=device,
              min_frame_size=min_frame_size, batch_frames=batch_frames,
              workers=workers, checksums=checksums)
    if isinstance(path_or_file, (str, Path)):
        f = open(path_or_file, "wb")
        return Writer(FileIO(f), owned_file=f, **kw)
    if isinstance(path_or_file, io.IOBase):
        return Writer(FileIO(path_or_file), **kw)
    return Writer(path_or_file, **kw)


def open_reader(path_or_file, *, device: str = "cuda", cache_frames: int = 8,
                readahead: int = 8, verify_checksums: bool = False,
                device_cache: bool = False, decoder: str = "auto") -> Reader:
    """Reader on a path, a binary file object, or a pread/fsize source.
    A path's file stays open for the reader's lifetime.  `decoder` picks
    the decode route (Reader): "auto", the JAX package's routes (zstd:
    transcode for host delivery, falling back to fused, and fused for
    device-resident frames; LZ4: the native host decoder, and the card's
    decoder for device-resident frames), or for zstd "fused" or
    "lanes"."""
    kw = dict(device=device, cache_frames=cache_frames, readahead=readahead,
              verify_checksums=verify_checksums, device_cache=device_cache,
              decoder=decoder)
    if isinstance(path_or_file, (str, Path)):
        return Reader(FileIO(open(path_or_file, "rb")), **kw)
    if isinstance(path_or_file, io.IOBase):
        return Reader(FileIO(path_or_file), **kw)
    return Reader(path_or_file, **kw)


# --- the C-API-shaped shims ---

def zseek_writer_open(file, codec: str = "zstd", level: int | None = None,
                      min_frame_size: int = DEFAULT_MIN_FRAME_SIZE, *,
                      device: str = "cuda") -> _writer.Writer:
    return open_writer(file, codec, level=level,
                       min_frame_size=min_frame_size, device=device)


def zseek_writer_open_full(file, params: CompressionParams | None = None,
                           min_frame_size: int = DEFAULT_MIN_FRAME_SIZE,
                           checksums: bool = False, *,
                           device: str = "cuda") -> _writer.Writer:
    """zseek_writer_open_full (zseek.h:225): params None means zstd at
    its defaults (level 3), as the reference library does; `checksums`
    turns on the seek table's per-frame checksums."""
    kw = dict(min_frame_size=min_frame_size, checksums=checksums,
              device=device)
    if params is None:
        return open_writer(file, "zstd", **kw)
    if params.type == "zstd":
        p = params.zstd or ZstdParams()
        return open_writer(file, "zstd", level=p.compression_level,
                           workers=p.nb_workers, **kw)
    if params.type == "lz4":
        p4 = params.lz4 or LZ4Params()
        return open_writer(file, "lz4", level=p4.compression_level,
                           workers=p4.nb_workers, **kw)
    raise ParameterError(f"unknown compression type {params.type!r}")


def zseek_reader_open_full(file, cache_size: int = 8, *,
                           device: str = "cuda") -> Reader:
    """zseek_reader_open_full (zseek.h:335): cache_size counts frames; 0
    turns the cache off (each pread decodes its frame)."""
    return open_reader(file, cache_frames=cache_size, device=device)


def zseek_write(writer: _writer.Writer, buf) -> bool:
    writer.write(buf)
    return True


def zseek_writer_close(writer: _writer.Writer) -> WriterStats:
    return writer.close()


def zseek_writer_stats(writer: _writer.Writer) -> WriterStats:
    return writer.stats()


def zseek_reader_open(file, cache_size: int = 8, *,
                      device: str = "cuda") -> Reader:
    return open_reader(file, cache_frames=cache_size, device=device)


def zseek_pread(reader: Reader, size: int, offset: int) -> bytes:
    return reader.pread(size, offset)


def zseek_read(reader: Reader, size: int) -> bytes:
    return reader.read(size)


def zseek_reader_close(reader: Reader) -> ReaderStats:
    return reader.close()


def zseek_reader_stats(reader: Reader) -> ReaderStats:
    return reader.stats()
