"""libzseek_tpu_torch: the PyTorch + CUDA port of libzseek_tpu.

Writes and reads seekable archives of zstd frames (with the seek table
and the decode-hints sidecar) or LZ4 frames on an NVIDIA GPU.  The zstd
encode chain runs hand-written CUDA kernels at every level for the
linked LZ77 parse (K1; from level 4 up with the dual table, lazy
matching and the repcode probe, on 64 KiB blocks), the fused entropy
emission (K2) and the literal placement (K3, on 128 KiB blocks), with
PyTorch ops around them, or the per-block hash parse (K7); zstd frames
decode with the fused decode kernel (K4) or the lane route (the lane
decoders and K6).  LZ4 frames are encoded by the fused LZ4 block
kernel (K5) and decoded by a CUDA LZ4 decoder.  A random-access Reader
serves both.  The format, writer, reader and a
native host library (built at first use) are the port's own copies of
the JAX package's, so it imports torch and nothing of jax or
libzseek_tpu.  `device="cuda"` is the default and needs a card;
`device="cpu"` runs each kernel's plain PyTorch version and exists for
the tests.
"""

__version__ = "0.3.0"

from libzseek_tpu_torch.api import (Reader, Writer, open_reader,  # noqa: F401
                                    open_writer)
from libzseek_tpu_torch.runtime.codec import LZ4Codec  # noqa: F401
from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec  # noqa: F401
