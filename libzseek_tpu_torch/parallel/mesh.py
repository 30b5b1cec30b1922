"""Frame-parallel scale-out over the devices of one process.

Counterpart of libzseek_tpu/parallel/mesh.py.  Frames (and their blocks)
are independent compression units, so the batch row axis is split over
devices, N devices standing in for the reference's N workers, with no
communication in the hot loop.  The mesh is a list of devices; a
row-sharded array is a list of tensors, one a device, holding contiguous
row blocks in device order, as NamedSharding(mesh, P(FRAME_AXIS)) places
them.  The only gathers are the runtime protocol's: the per-frame
compressed lengths and the frame payloads, to the host in frame order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.utils import device as udev

FRAME_AXIS = "frames"


def frame_mesh(devices=None, n: int | None = None) -> list[torch.device]:
    """1-D mesh over the frame (batch-row) axis, the workers knob: the
    given devices, or every visible CUDA device; `n` limits the count
    (the reference's nb_workers, src/zseek.h:136-139)."""
    if devices is None:
        devices = udev._visible_devices(torch.device("cuda"))
    devices = [torch.device(d) for d in devices]
    if n is not None:
        devices = devices[:n]
    if not devices:
        raise ParameterError("frame_mesh: no devices")
    return devices


def pad_rows(arrs: list[np.ndarray], multiple: int):
    """Pad the leading (frame) axis of each array to a multiple of the mesh
    size so rows divide evenly across devices.  Returns (padded, orig_rows)."""
    rows = arrs[0].shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return arrs, rows
    out = []
    for a in arrs:
        pad = [(0, target - rows)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad))
    return out, rows


def shard_rows(mesh: list[torch.device], *arrays):
    """Each array with its rows split in contiguous, equal blocks over the
    mesh's devices, in order: a list of tensors, one a device."""
    n = len(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % n:
            raise ParameterError(
                f"{t.shape[0]} rows do not split over {n} devices "
                f"(pad_rows first)")
        per = t.shape[0] // n
        out.append([t[k * per: (k + 1) * per].to(d)
                    for k, d in enumerate(mesh)])
    return tuple(out)


def row_sharding(mesh: list[torch.device]):
    """The reference's NamedSharding(mesh, P(FRAME_AXIS)), kept for the
    API's parity: a callable that places arrays as shard_rows does."""
    return functools.partial(shard_rows, mesh)


def to_host(x) -> np.ndarray:
    """A row-sharded array (its shards in order), a tensor or an array,
    whole on the host."""
    if isinstance(x, (list, tuple)):
        return np.concatenate([to_host(s) for s in x])
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# per-frame compressed lengths to the host, in frame order (the reference
# analog: the writer thread learning each worker's output size as it
# drains ZSTD_compressStream2, src/compress.c:294-333)
gather_frame_lengths = to_host


def ordered_gather(payloads, lengths) -> list[np.ndarray]:
    """Variable-length frame payloads on the host in frame order, each row
    pulled from the device that holds it."""
    host = to_host(payloads)
    lens = gather_frame_lengths(lengths)
    return [host[i, : lens[i]] for i in range(host.shape[0])]
