"""Multi-process scale-out over torch.distributed.

Counterpart of libzseek_tpu/parallel/distributed.py (jax.distributed):

  * every process runs the same program; each compresses its shard of the
    frame list on its own device;
  * per-process frame counts and per-frame (compressed, decompressed)
    sizes are all-gathered (tiny);
  * frame payloads, padded to one shared cap, are all-gathered in frame
    order (process order, then local order), and process 0 writes them
    and then the seek table, preserving the archive's ordering contract.

The process group is gloo: every tensor the protocol moves is host memory
(the codec returns its payloads as bytes), and gloo, unlike NCCL, also
runs several processes on one GPU.  A single process that configured
nothing runs the same code with no collectives.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.parallel.mesh import to_host


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group (a no-op when nothing is configured).  The
    arguments default from MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK.
    On a card, the process's current device becomes LOCAL_RANK (default:
    its rank) modulo the visible devices."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = \
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None and num_processes is None:
        return  # single process
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "0"))
    if process_id is None:
        process_id = int(env.get("RANK", "-1"))
    if coordinator_address is None or num_processes < 1 or \
            not 0 <= process_id < num_processes:
        raise ParameterError(
            f"initialize: coordinator {coordinator_address!r}, "
            f"{num_processes} processes, process id {process_id}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    if torch.cuda.is_available():
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())


def _world() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _process_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_frame_mesh() -> list[torch.device]:
    """1-D mesh over every process's device, in rank order."""
    rank, world = _world()
    if world == 1:
        return [_process_device()]
    names = [None] * world
    dist.all_gather_object(names, str(_process_device()))
    return [torch.device(n) for n in names]


def is_writer_process() -> bool:
    return _world()[0] == 0


def replicate_to_hosts(mesh, sharded) -> np.ndarray:
    """A row-sharded array on every process: this process's rows (its
    shards in order) all-gathered in rank order.  Every process passes
    the same shape; `mesh` (the reference's argument) is not needed,
    the process group orders the ranks."""
    local = np.ascontiguousarray(to_host(sharded))
    _, world = _world()
    if world == 1:
        return local
    t = torch.from_numpy(local)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()


def gather_frames_in_order(mesh, payloads, lengths) -> list[bytes]:
    """Every process participates; returns the ordered frame payloads
    (only meaningful on the writer process, but safe everywhere).

    payloads: (B, CAP) row-sharded compress-bound-padded frame bytes;
    lengths: (B,) true byte counts."""
    host_payloads = replicate_to_hosts(mesh, payloads)
    host_lengths = replicate_to_hosts(mesh, lengths)
    return [host_payloads[i, : int(host_lengths[i])].tobytes()
            for i in range(host_payloads.shape[0])]


def write_archive(sink, local_frames, codec=None):
    """Multi-process seekable-archive write.  Every process calls this
    with ITS shard of the frame list (global frame order = process order,
    then local order); each compresses its shard on its own device, the
    payloads gather in frame order, and process 0 writes the complete
    archive (frames + seek table).  Returns the number of frames written
    on process 0, None on the others.  The default codec is
    ZstdCodec(collect_hints=False) on the process's card.

    The reference's nearest analog is N zstd worker threads feeding one
    writer (src/compress.c:599-648); here the workers are processes and
    the drain is one ordered gather."""
    from libzseek_tpu_torch.format.seek_table import FrameLog

    if codec is None:
        from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
        codec = ZstdCodec(collect_hints=False)
    local_frames = list(local_frames)
    payloads = codec.compress_frames(local_frames)
    rank, nproc = _world()

    # global geometry: per-process frame counts, then each frame's sizes
    # and the payloads' shared byte cap
    counts = replicate_to_hosts(
        None, np.array([len(payloads)], np.int64)).reshape(-1)
    rows = int(counts.max())
    local_meta = np.zeros((rows, 2), np.int64)
    for i, (p, f) in enumerate(zip(payloads, local_frames)):
        local_meta[i] = (len(p), len(f))
    metas = replicate_to_hosts(None, local_meta).reshape(-1, 2)
    cap = int(max(1, metas[:, 0].max(initial=0)))
    cap += (-cap) % 4

    local_pay = np.zeros((rows, cap), np.uint8)
    for i, p in enumerate(payloads):
        local_pay[i, : len(p)] = np.frombuffer(p, np.uint8)
    ordered = gather_frames_in_order(None, local_pay, local_meta[:, 0])

    if rank != 0:
        return None
    fl = FrameLog()
    written = 0
    for pi in range(nproc):
        for k in range(int(counts[pi])):
            row = pi * rows + k
            c, d = int(metas[row, 0]), int(metas[row, 1])
            sink.write(ordered[row][:c])
            fl.log_frame(c, d)
            written += 1
    sink.write(fl.serialize())
    return written
