"""The decoders launched from two host threads at once, as the Reader's
two prefetch threads launch them: one thread's batches need the most
dynamic shared memory a decoder kernel takes, the other's little.  A
kernel's shared-memory attribute is shared by every thread, so a thread
that set it to its own small launch's size made the other thread's
larger launch fail ("CUDA error 1 at launch").

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests).  On the GPU machine (no
jax there, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Decoded bytes must equal the input (tolerance: none)."""

import threading

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import lz4_decode as LD
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import log_corpus, text_corpus
from test_torch_cuda_inputs import (cuda_device, rows_of_blocks, seq_block,
                                    words)

pytestmark = pytest.mark.cuda


def _in_two_threads(jobs, rounds):
    """Run each job `rounds` times, the jobs on threads of their own,
    started together; raise the first error any of them met."""
    errors = []
    start = threading.Barrier(len(jobs))

    def run(job):
        try:
            start.wait()
            for _ in range(rounds):
                job()
        except Exception as e:     # re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def test_lz4_decoder_from_two_threads():
    cuda = cuda_device()
    frames = [[(seq_block([(b"ab", 2, 61), (b"XYZ", 3, 300)], b"END"),
                False)]] * 8
    jobs, results = [], []
    for M in (128 * 1024, 4096):     # staged: 96 KiB a block, and 4 KiB
        comp, clens, unc = (torch.from_numpy(a) for a in
                            rows_of_blocks(frames, M))
        ref = LD.lz4_decode_frames(comp, clens, unc, 4096)
        args = [a.to(cuda) for a in (comp, clens, unc)]
        got = []
        jobs.append(lambda args=args, got=got: got.append(
            LD.lz4_decode_frames(*args, 4096)))
        results.append((got, ref))
    _in_two_threads(jobs, 1000)     # no sync inside: launches overlap
    for got, ref in results:
        assert len(got) == 1000
        for out, out_lens, ok in got:
            assert ok.all()
            assert torch.equal(out_lens.cpu(), ref[1])
            assert torch.equal(out.cpu(), ref[0])


def test_zstd_decoder_from_two_threads():
    """The fused route (K4) with 128 KiB text frames, whose literals
    fill the most staged shared memory, beside 2 KiB frames; then the
    lane route, whose tagged sequence arm stages each stream: libzstd
    level-9 frames of vocabulary text (~35 KB streams in 64 KiB rows)
    beside 2 KiB frames of log-like lines; then the transcode route on
    the same frames, whose row walk stages each stream as well."""
    cuda_device()
    rng = np.random.default_rng(17)
    codec = ZstdCodec(device="cuda", decoder="fused")
    jobs = []
    for n, size in ((4, 128 * 1024), (8, 2048)):
        raws = [text_corpus(rng, size).tobytes() for _ in range(n)]
        frames = codec.compress_frames(raws)
        sizes = [len(r) for r in raws]

        def job(frames=frames, sizes=sizes, raws=raws):
            assert codec.decompress_frames(frames, sizes) == raws
        jobs.append(job)
    _in_two_threads(jobs, 40)
    batches = []
    for n, size, text, level in ((2, 256 * 1024, words, 9),
                                 (8, 2048, log_corpus, 3)):
        raws = [text(rng, size).tobytes() for _ in range(n)]
        frames = [golden.zstd_compress(r, level=level) for r in raws]
        batches.append((frames, [len(r) for r in raws], raws))
    # the lane route, then the transcode route (K4's row walk stages each
    # row's stream too)
    for route, count in ((ZD.decode_frames_lanes,
                          lambda: L.seq_tagged_launches),
                         (ZD.decode_frames_transcode,
                          lambda: D.transcode_launches)):
        def job(b, route=route):
            assert route(*b[:2], device="cuda") == b[2]
        before = count()
        _in_two_threads([lambda b=b: job(b) for b in batches], 10)
        assert count() >= before + 20
