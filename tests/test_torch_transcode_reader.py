"""Reader(device="cpu", decoder="auto"), whose host delivery takes the
transcode route, over archives of the port's Writer: it loads the hints sidecar, reads sequentially, serves random
pread_full calls and keeps a device cache (device-resident frames take
the fused route), every byte equal to the input, every batch through
K4's transcode arm without a fallback; and over an archive of the JAX
package's Writer."""

import io

import numpy as np
import torch

from libzseek_tpu import api as jax_api
import libzseek_tpu_torch as port
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_lanes_inputs import mixed_archive, words_archive


def _read_all(r, n=5000):
    parts = []
    while chunk := r.read(n):
        parts.append(chunk)
    return b"".join(parts)


def test_reader_transcode_reads_the_input():
    before = dict(ZD.routes)
    for archive, data in (mixed_archive(), words_archive()):
        r = port.Reader(archive, device="cpu", decoder="auto",
                        readahead=2, cache_frames=4)
        assert r._hints is not None
        assert _read_all(r) == data
        r.close()
        rng = np.random.default_rng(67)
        r = port.Reader(archive, device="cpu", decoder="auto",
                        cache_frames=2)
        for off in rng.integers(0, len(data) - 3000, 12).tolist():
            assert r.pread_full(3000, off) == data[off: off + 3000]
        r.close()
    done = ZD.routes["transcode_batches"] - before["transcode_batches"]
    assert done >= 4
    assert ZD.routes["transcode_fallback_batches"] == \
        before["transcode_fallback_batches"]
    assert ZD.routes["transcode_rule_batches"] == \
        before["transcode_rule_batches"]
    rd = port.Reader(archive, device="cpu", decoder="auto",
                     device_cache=True)
    for off in (0, 20000, len(data) - 100):
        assert rd.pread_full(100, off) == data[off: off + 100]
    assert all(isinstance(c, torch.Tensor) for c in rd._cache._map.values())
    rd.close()
    assert ZD.routes["transcode_batches"] - before["transcode_batches"] \
        == done


def test_reader_transcode_jax_writer_archive():
    data = mixed_corpus(np.random.default_rng(61), 384 * 1024).tobytes()
    sink = io.BytesIO()
    w = jax_api.Writer(sink, min_frame_size=128 * 1024)
    for pos in range(0, len(data), 128 * 1024):
        w.write(data[pos: pos + 128 * 1024])
    w.close()
    r = port.Reader(sink.getvalue(), device="cpu", decoder="auto")
    assert r._hints is not None and r.seek_table.num_frames == 3
    assert r.pread_full(len(data), 0) == data
    r.close()
