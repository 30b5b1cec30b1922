"""Reader(device="cpu", decoder="lanes") on an archive of the port's
Writer with its sidecar: a sequential read, random pread_full calls and
the device cache return the input, through anchored lanes and K6."""

import numpy as np
import torch

import libzseek_tpu_torch as port
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_lanes_inputs import words_archive


def test_reader_lanes_reads_the_input():
    archive, data = words_archive()
    before = dict(ZD.routes)
    r = port.Reader(archive, device="cpu", decoder="lanes", readahead=2,
                    cache_frames=4)
    parts = []
    while chunk := r.read(5000):
        parts.append(chunk)
    assert b"".join(parts) == data
    r.close()
    routes = {k: ZD.routes[k] - before[k] for k in before}
    assert routes["anchored_frames"] >= 1 and routes["plain_frames"] >= 1
    assert routes["k6_batches"] >= 1
    rng = np.random.default_rng(67)
    r = port.Reader(archive, device="cpu", decoder="lanes", cache_frames=2)
    for off in rng.integers(0, len(data) - 3000, 12).tolist():
        assert r.pread_full(3000, off) == data[off: off + 3000]
    r.close()
    rd = port.Reader(archive, device="cpu", decoder="lanes",
                     device_cache=True)
    for off in (0, 20000, len(data) - 100):
        assert rd.pread_full(100, off) == data[off: off + 100]
    assert all(isinstance(c, torch.Tensor)
               for c in rd._cache._map.values())
    rd.close()
