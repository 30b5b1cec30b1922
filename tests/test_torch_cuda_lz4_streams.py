"""The LZ4 stream's batches on the card at once: each batch of a stream
on a CUDA stream of its own, the finishing thread waiting on each
batch's own event (runtime/codec.py, _LZ4Stream).  6 MiB of mixed data
in 1 MiB frames, in batches of 16 blocks, so that six launches are in
flight against a depth of 4.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests).  On the GPU machine (no jax
there, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Frames must be equal byte for byte (tolerance: none).  Two tests, so the
file queues after the JAX package's larger files (ROADMAP.md C)."""

import io
import threading

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import LZ4Codec
from libzseek_tpu_torch.runtime.writer import Writer
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from libzseek_tpu_torch.utils import trace
from test_torch_cuda_inputs import cuda_device

pytestmark = pytest.mark.cuda

MIB = 1 << 20


def _frames():
    data = mixed_corpus(np.random.default_rng(61), 6 * MIB).tobytes()
    return data, [data[i: i + MIB] for i in range(0, len(data), MIB)]


def _stream(codec, frames, depth):
    s = codec.begin_stream(depth=depth)
    return [f for out, _ in s.submit(frames) + s.finish() for f in out]


def test_concurrent_batches_keep_the_bytes():
    cuda_device()
    data, frames = _frames()
    codec = LZ4Codec(device="cuda", max_batch_blocks=16)
    four = _stream(codec, frames, 4)
    assert four == _stream(codec, frames, 1)
    assert four[0] == LZ4Codec(device="cpu", max_batch_blocks=16) \
        .compress_frames(frames[:1])[0]
    buf = io.BytesIO()
    w = Writer(buf, codec=codec, min_frame_size=MIB, batch_frames=6)
    for f in frames:
        w.write(f)
    w.close()
    assert golden.lz4f_decompress(buf.getvalue()) == data
    assert b"".join(four) in buf.getvalue()


def test_overlap_is_marked_and_fetches_wait_for_their_batch(monkeypatch):
    cuda_device()
    _, frames = _frames()
    codec = LZ4Codec(device="cuda", max_batch_blocks=16)
    _stream(codec, frames[:1], 4)                   # builds the kernels
    current = threading.local()
    early = []
    finish, keep = codec._finish_batch, trace._keep

    def finish_batch(B, staged):
        current.staged = staged
        return finish(B, staged)

    def keep_entry(entry):
        # a fetch span closes here: its batch's event must have fired
        if entry.name == "zseek.fetch" and \
                not current.staged["done"].query():
            early.append(entry)
        keep(entry)

    monkeypatch.setattr(codec, "_finish_batch", finish_batch)
    monkeypatch.setattr(trace, "_keep", keep_entry)
    trace.drain()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _stream(codec, frames, 4)
    log = trace.drain()
    names = [s.name for s in log]
    assert names.count("zseek.dispatch") == 6
    assert names.count("zseek.fetch") == 6
    assert names.count("zseek.overlap") >= 1
    dispatch = {s.id for s in log if s.name == "zseek.dispatch"}
    assert all(s.cause in dispatch and s.start_ns == s.end_ns
               for s in log if s.name == "zseek.overlap")
    assert not early
    assert got == _stream(codec, frames, 1)
