"""The port's frame mesh (libzseek_tpu_torch/parallel/mesh.py) against
the JAX package's (libzseek_tpu/parallel/mesh.py) on conftest's 8
virtual CPU devices, the port's mesh being 8 CPU devices indexed 0-7:
pad_rows, the rows shard_rows places on each device index, and the
host gathers in frame order (ordered_gather, gather_frame_lengths,
the single-process distributed.gather_frames_in_order).  Arrays and
bytes, compared exactly, on inputs from numpy seeds."""

import jax
import numpy as np
import pytest
import torch

from libzseek_tpu.parallel import distributed as JD
from libzseek_tpu.parallel import mesh as JM
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.parallel import distributed as PD
from libzseek_tpu_torch.parallel import mesh as PM


def _meshes(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return (JM.frame_mesh(jax.devices()[:n]),
            PM.frame_mesh([torch.device("cpu", i) for i in range(n)]))


def test_mesh_matches_jax():
    jmesh, pmesh = _meshes()
    assert PM.FRAME_AXIS == JM.FRAME_AXIS
    assert PM.frame_mesh(pmesh, n=3) == pmesh[:3]
    with pytest.raises(ParameterError):
        PM.frame_mesh([])
    rng = np.random.default_rng(17)
    for rows, mult in ((5, 8), (8, 8), (13, 4), (5, 5)):
        arrs = [rng.integers(0, 256, (rows, 6), np.uint8),
                rng.integers(0, 1 << 20, (rows,), np.int32)]
        got, n = PM.pad_rows(arrs, mult)
        want, m = JM.pad_rows(arrs, mult)
        assert n == m == rows
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert (g is arrs[0] or g is arrs[1]) == (rows % mult == 0)
    payloads = rng.integers(0, 256, (16, 24), np.uint8)
    lengths = rng.integers(1, 25, 16).astype(np.int32)
    ps, ls = PM.shard_rows(pmesh, payloads, lengths)
    js, jl = JM.shard_rows(jmesh, payloads, lengths)
    for a, b in zip(PM.row_sharding(pmesh)(payloads)[0], ps):
        assert torch.equal(a, b)
    for port_shards, jarr in ((ps, js), (ls, jl)):
        assert len(port_shards) == len(jmesh.devices)
        for shard in jarr.addressable_shards:
            k = list(jmesh.devices).index(shard.device)
            np.testing.assert_array_equal(port_shards[k].numpy(),
                                          np.asarray(shard.data))
    np.testing.assert_array_equal(PM.gather_frame_lengths(ls),
                                  JM.gather_frame_lengths(jl))
    for g, w in zip(PM.ordered_gather(ps, ls), JM.ordered_gather(js, jl)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ParameterError):
        PM.shard_rows(pmesh, payloads[:15])


def test_gather_frames_in_order_single_process():
    jmesh, pmesh = _meshes()
    rng = np.random.default_rng(19)
    payloads = rng.integers(0, 256, (8, 16), np.uint8)
    lengths = np.arange(1, 9, dtype=np.int32) * 2
    ps, ls = PM.shard_rows(pmesh, payloads, lengths)
    js, jl = JM.shard_rows(jmesh, payloads, lengths)
    got = PD.gather_frames_in_order(pmesh, ps, ls)
    assert got == JD.gather_frames_in_order(jmesh, js, jl)
    assert got[3] == payloads[3, :8].tobytes()
    assert PD.is_writer_process() and JD.is_writer_process()
    assert len(PD.global_frame_mesh()) == 1
