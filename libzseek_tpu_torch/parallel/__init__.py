"""Scale-out: frame-axis sharding over one process's devices and
torch.distributed multi-process helpers.  See mesh.py, distributed.py
and dryrun.py."""

from libzseek_tpu_torch.parallel.mesh import (  # noqa: F401
    FRAME_AXIS, frame_mesh, gather_frame_lengths, ordered_gather, pad_rows,
    row_sharding, shard_rows,
)
