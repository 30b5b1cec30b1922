"""libzseek_tpu_torch: the PyTorch + CUDA port of libzseek_tpu.

Writes and reads seekable archives of zstd frames (with the seek table
and the decode-hints sidecar) or LZ4 frames on an NVIDIA GPU.  The zstd
encode chain runs hand-written CUDA kernels at every level for the
linked LZ77 parse (K1; from level 4 up with the dual table, lazy
matching and the repcode probe, on 64 KiB blocks), the fused entropy
emission (K2) and the literal placement (K3, on 128 KiB blocks), with
PyTorch ops around them, or the per-block hash parse (K7), or the exact
sort parser (PyTorch ops with the greedy_select kernel, for zstd and
LZ4); zstd frames decode with the fused decode kernel (K4), the lane
route (the lane decoders and K6) or the transcode route (K4's transcode
arm).  LZ4 frames are encoded by the fused LZ4 block kernel (K5) or the
sort parser and decoded by a CUDA LZ4 decoder.  A random-access Reader
serves both.  The public API is the JAX package's: Writer/Reader,
open_writer/open_reader, the parameter structs and the nine zseek_*
shims.  The format, writer, reader and a
native host library (built at first use) are the port's own copies of
the JAX package's, so it imports torch and nothing of jax or
libzseek_tpu.  `device="cuda"` is the default and needs a card;
`device="cpu"` runs each kernel's plain PyTorch version and exists for
the tests.
"""

__version__ = "0.3.0"

from libzseek_tpu_torch.api import (  # noqa: F401
    Reader, Writer, open_reader, open_writer,
    zseek_pread, zseek_read, zseek_reader_close, zseek_reader_open,
    zseek_reader_stats, zseek_write, zseek_writer_close, zseek_writer_open,
    zseek_writer_stats,
)
from libzseek_tpu_torch.errors import ZseekError  # noqa: F401
from libzseek_tpu_torch.runtime.codec import LZ4Codec  # noqa: F401
from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec  # noqa: F401
