"""A dry run of the frame-parallel write over n devices.

Counterpart of the JAX package's __graft_entry__.dryrun_multichip: one
example batch's rows sharded over frame_mesh(n=n), the write chain run on
each shard's device, the compressed lengths gathered in frame order,
then a small archive written with workers=n and read back.

    python -m libzseek_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import io
import sys

import numpy as np
import torch

from libzseek_tpu_torch.parallel.mesh import (frame_mesh,
                                              gather_frame_lengths,
                                              shard_rows)


def example_batch(B: int, N: int) -> np.ndarray:
    """(B, N) rows: half letters a-h, half a repeated 96-byte pattern (the
    JAX package's _example_batch, seed 0)."""
    rng = np.random.default_rng(0)
    parts = [rng.integers(97, 105, N // 2, np.uint8),
             np.tile(rng.integers(0, 256, 96, np.uint8), N // 2 // 96 + 1)
             [: N - N // 2]]
    return np.concatenate(parts)[None, :].repeat(B, 0)


def dryrun(n: int) -> None:
    from libzseek_tpu_torch.runtime.reader import Reader
    from libzseek_tpu_torch.runtime.writer import Writer
    from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec

    mesh = frame_mesh(n=n)
    n = len(mesh)
    (shards,) = shard_rows(mesh, example_batch(B=n, N=2048))
    lengths = []
    for dev, rows in zip(mesh, shards):
        codec = ZstdCodec(device=dev, collect_hints=False)
        out = codec.compress_frames(
            [r.cpu().numpy().tobytes() for r in rows])
        lengths.append(torch.tensor([len(p) for p in out], device=dev))
    sizes = gather_frame_lengths(lengths)
    assert sizes.shape == (n,) and (sizes > 0).all(), sizes

    # the write chain with the workers knob: batches round-robin over the
    # mesh's devices; the archive is read back whole
    rng = np.random.default_rng(1)
    data = (np.tile(rng.integers(0, 256, 977, np.uint8), 300).tobytes()
            + rng.integers(0, 256, 40_000, np.uint8).tobytes())
    codec = ZstdCodec(device=mesh[0], workers=n, max_batch_blocks=2)
    buf = io.BytesIO()
    w = Writer(buf, codec=codec, min_frame_size=1 << 17, batch_frames=2)
    for pos in range(0, len(data), 100_000):
        w.write(data[pos: pos + 100_000])
    w.close()
    got = Reader(buf.getvalue(), device=mesh[0]).pread_full(len(data), 0)
    assert got == data, "sharded chain round-trip mismatch"


if __name__ == "__main__":
    dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else
           torch.cuda.device_count())
    print("DRYRUN-OK", flush=True)
