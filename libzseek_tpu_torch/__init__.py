"""libzseek_tpu_torch: the PyTorch + CUDA port of libzseek_tpu.

Writes and reads zstd seekable archives (zstd frames, seek table,
decode-hints sidecar) on an NVIDIA GPU.  The level <= 3 encode chain runs
hand-written CUDA kernels for the linked LZ77 parse (K1), the fused
entropy emission (K2) and the literal placement (K3), with PyTorch ops
around them; the read path decodes frames with the fused decode kernel
(K4) behind a random-access Reader.  The format, writer, reader and a
native host library (built at first use) are the port's own copies of
the JAX package's, so it imports torch and nothing of jax or
libzseek_tpu.  `device="cuda"` is the default and needs a card;
`device="cpu"` runs each kernel's plain PyTorch version and exists for
the tests.
"""

__version__ = "0.2.0"

from libzseek_tpu_torch.api import (Reader, Writer, open_reader,  # noqa: F401
                                    open_writer)
from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec  # noqa: F401
