"""Writer/reader statistics structs.

Parity with zseek_writer_stats_t / zseek_reader_stats_t
(the reference library's src/zseek.h:174-203; impls
src/compress.c:835-881, src/decompress.c:837-891).  As in the reference,
sizes reflect data the framework has seen; device-side buffering means
some figures are estimates.

Copy of libzseek_tpu/runtime/stats.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WriterStats:
    seek_table_size: int = 0       # serialized size if closed now
    seek_table_memory: int = 0     # in-memory frame log footprint
    frames: int = 0                # frames fully written out
    compressed_size: int = 0       # compressed bytes emitted so far
    buffered_size: int = 0         # bytes pending in the chunk coalescer
    decompressed_size: int = 0     # total input bytes accepted
    sidecar_size: int = 0          # decode-hints skippable frame bytes


@dataclasses.dataclass
class ReaderStats:
    seek_table_size: int = 0
    seek_table_memory: int = 0
    frames: int = 0
    compressed_size: int = 0       # archive payload size (sans seek table)
    decompressed_size: int = 0
    cache_memory: int = 0
    cache_entries: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
