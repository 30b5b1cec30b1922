"""decode_frames_lanes against the JAX package's decode_frames, whose CPU
default is the same lane route (ZN_DECODE_SMEM=off is set all the same):
the same bytes, equal to the input, with and without the Writer's hints,
on frames of the port's Writer and of the JAX Writer (tolerance: none)."""

import io

import numpy as np

from libzseek_tpu import api as jax_api
from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu.runtime.reader import Reader as JaxReader
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_lanes_inputs import (NO_TRANSCODE, archive_parts,
                                     mixed_archive, words_archive)


def _both(monkeypatch, frames, sizes, hints):
    monkeypatch.setenv("ZN_DECODE_SMEM", "off")
    ref = JZ.decode_frames(frames, sizes, hints)
    before = dict(ZD.routes)
    got = ZD.decode_frames_lanes(frames, sizes, hints, device="cpu")
    assert got == ref
    return got, {k: ZD.routes[k] - before[k] for k in before}


def test_decode_frames_lanes_port_frames(monkeypatch):
    """The mixed archive (every frame anchored) and the words archive (an
    anchored frame and one whose rep2/rep3 block takes the plain lanes)
    in one batch, then without hints (but for the text frame: the
    reference's plain lanes on libzstd's large streams are
    test_torch_lanes_stock.py's)."""
    (a1, d1), (a2, d2) = mixed_archive(), words_archive()
    f1, s1, h1 = archive_parts(a1)
    f2, s2, h2 = archive_parts(a2)
    frames, sizes, hints = f1 + f2, s1 + s2, h1 + h2
    got, routes = _both(monkeypatch, frames, sizes, hints)
    assert b"".join(got) == d1 + d2
    assert routes == {"anchored_frames": 5, "plain_frames": 1,
                      "k6_batches": 1, "pointer_doubling_batches": 0,
                      **NO_TRANSCODE}
    got, routes = _both(monkeypatch, frames[1:], sizes[1:], None)
    assert b"".join(got) == (d1 + d2)[sizes[0]:]
    assert routes["plain_frames"] == 5 and routes["k6_batches"] == 1


def test_decode_frames_lanes_jax_writer_frames(monkeypatch):
    """An archive of the JAX package's Writer (its CPU default parser),
    with the hints of its own sidecar as the JAX Reader loads them."""
    data = mixed_corpus(np.random.default_rng(61), 384 * 1024).tobytes()
    sink = io.BytesIO()
    w = jax_api.Writer(sink, min_frame_size=128 * 1024)
    for pos in range(0, len(data), 128 * 1024):
        w.write(data[pos: pos + 128 * 1024])
    w.close()
    archive = sink.getvalue()
    j = JaxReader(archive)
    n = j.seek_table.num_frames
    frames = [j._read_frame_bytes(i) for i in range(n)]
    sizes = [j.seek_table.frame_d_size(i) for i in range(n)]
    for hints in (j._hints, None):
        got, _ = _both(monkeypatch, frames, sizes, hints)
        assert b"".join(got) == data
