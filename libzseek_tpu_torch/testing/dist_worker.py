"""One process of the multi-process write over torch.distributed (gloo).

    python -m libzseek_tpu_torch.testing.dist_worker RANK WORLD PORT DEVICE [MIB]

Counterpart of the JAX package's tests/distributed_worker.py.  Every
process joins the group at tcp://127.0.0.1:PORT and runs two parts:

  * an ordered gather of crafted rows: 8 rows of 64 bytes, each process
    holding its contiguous share, gathered in frame order by
    gather_frames_in_order;
  * the product write, write_archive, with shards uneven on purpose: with
    MIB, mixed_corpus (seed 11) of MIB MiB in 1 MiB frames, process r
    taking a share in proportion to 2r + 3 (24 and 40 of 64 frames for
    two); without it, small crafted frames, 2 + r on process r.

Process 0 prints DIST-OK after the gather and, after the write,
DIST-WRITE-OK with the archive's frames, bytes, sha256 and the write's
MiB/s, once stock libzstd has decoded the archive to the input.  `frames`
gives the whole input's frames, so a single process can make the archive
to compare with (write_archive at world size 1).
"""

from __future__ import annotations

import hashlib
import io
import sys
import time

import numpy as np

FRAME = 1 << 20


def frames(world: int, mib: int | None = None) -> list[list[bytes]]:
    """Each process's frames, in rank order."""
    if mib:
        from libzseek_tpu_torch.testing.corpus import mixed_corpus
        data = mixed_corpus(np.random.default_rng(11), mib << 20).tobytes()
        allf = [data[i: i + FRAME] for i in range(0, len(data), FRAME)]
        w = np.cumsum([0] + [2 * r + 3 for r in range(world)])
        cut = [len(allf) * int(x) // int(w[-1]) for x in w]
        return [allf[a:b] for a, b in zip(cut, cut[1:])]
    out = []
    for r in range(world):
        rng = np.random.default_rng(100 + r)
        out.append([(b"process %d frame %d " % (r, k)) * 600
                    + rng.integers(0, 256, 512, np.uint8).tobytes()
                    for k in range(2 + r)])
    return out


def main(argv: list[str]) -> None:
    import torch

    from libzseek_tpu_torch.parallel import distributed as dist
    from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
    from libzseek_tpu_torch.testing import golden

    rank, world, port = int(argv[0]), int(argv[1]), argv[2]
    device = argv[3]
    mib = int(argv[4]) if len(argv) > 4 else None
    dist.initialize(f"127.0.0.1:{port}", num_processes=world,
                    process_id=rank)
    assert dist._world() == (rank, world)
    mesh = dist.global_frame_mesh()
    assert len(mesh) == world

    B, CAP = 8, 64
    rows = np.stack([(np.arange(CAP) + 10 * i).astype(np.uint8)
                     for i in range(B)])
    lengths = (np.arange(B, dtype=np.int32) % CAP) + 3
    per = B // world
    mine = slice(rank * per, (rank + 1) * per)
    got = dist.gather_frames_in_order(
        mesh, torch.from_numpy(rows[mine]).to(device),
        torch.from_numpy(lengths[mine]).to(device))
    assert len(got) == B
    for i, fr in enumerate(got):
        assert fr == rows[i, : lengths[i]].tobytes(), (rank, i)
    if dist.is_writer_process():
        print("DIST-OK", flush=True)

    shards = frames(world, mib)
    codec = ZstdCodec(device=device, collect_hints=False)
    sink = io.BytesIO()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    wrote = dist.write_archive(sink, shards[rank], codec=codec)
    secs = time.perf_counter() - t0
    if dist.is_writer_process():
        want = b"".join(f for shard in shards for f in shard)
        assert wrote == sum(map(len, shards)), wrote
        arch = sink.getvalue()
        assert golden.zstd_decompress(arch) == want, "archive mismatch"
        print(f"DIST-WRITE-OK frames={wrote} bytes={len(arch)} "
              f"sha256={hashlib.sha256(arch).hexdigest()} "
              f"mib_s={len(want) / secs / (1 << 20):.2f}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
