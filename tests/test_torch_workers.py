"""`workers` across devices: the codecs' round-robin of batches over the
first `workers` devices (libzseek_tpu/runtime/zstd_codec.py:128-133,
runtime/codec.py:72-77 and _put), on four CPU devices injected through
utils/device._visible_devices: here the linked zstd parser (also with the
long-distance override, on data that repeats blocks 192 KiB apart) and
LZ4; tests/test_torch_workers_parsers.py takes the sort and hash parsers.
The archives are byte-identical to workers=1's (which the other tests
hold to the JAX Writer's), `_rr` counts the batches, and stock
libzstd/liblz4 decode them.  The dry run (parallel/dryrun.py, the
counterpart of __graft_entry__.dryrun_multichip) runs on the same four
devices.  The writes and the dry run take one torch thread: their ops
gain nothing from more, and in a parallel test run more only contend."""

import contextlib
import io

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.parallel.dryrun import dryrun
from libzseek_tpu_torch.runtime import zstd_codec as ZC
from libzseek_tpu_torch.runtime.codec import LZ4Codec
from libzseek_tpu_torch.runtime.writer import Writer
from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from libzseek_tpu_torch.utils import device as udev

FOUR = [torch.device("cpu", i) for i in range(4)]
K = 64 << 10


def mixed_512k() -> bytes:
    return mixed_corpus(np.random.default_rng(29), 512 << 10).tobytes()


def zstd(batch, **kw):
    return lambda w: ZstdCodec(device="cpu", level=3, workers=w,
                               max_batch_blocks=batch, **kw)


def _write(codec, data, frame):
    buf = io.BytesIO()
    w = Writer(buf, codec=codec, min_frame_size=frame, batch_frames=2)
    for pos in range(0, len(data), K):
        w.write(data[pos: pos + K])
    w.close()
    return buf.getvalue()


@contextlib.contextmanager
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def round_robin_matches(monkeypatch, make, dispatch, decode, src, frame,
                        ldm=False):
    """Write `src` with make(1) and make(4) over FOUR; the archives are
    equal, every batch took a device (`_rr`), there are >= 4 batches, the
    long-distance override ran iff `ldm`, and `decode` returns `src`."""
    with one_torch_thread():
        one = _write(make(1), src, frame)
        with monkeypatch.context() as mp:
            mp.setattr(udev, "_visible_devices", lambda dev: FOUR)
            codec = make(4)
            assert codec._devices == FOUR
            batches, overrides = [], []
            real = getattr(codec, dispatch)
            mp.setattr(codec, dispatch,
                       lambda *a, **k: batches.append(1) or real(*a, **k))
            override = ZC.apply_ldm_override
            mp.setattr(ZC, "apply_ldm_override",
                       lambda *a, **k: overrides.append(1)
                       or override(*a, **k))
            four = _write(codec, src, frame)
    assert codec._rr == len(batches) >= 4
    assert bool(overrides) == ldm
    assert four == one
    assert decode(four) == src


@pytest.mark.skipif(not (golden.have_zstd() and golden.have_lz4()),
                    reason="system libzstd/liblz4 unavailable")
def test_round_robin_archives_match_one_worker(monkeypatch):
    data = mixed_512k()
    # in 64 KiB blocks, every fourth block repeats the block 192 KiB
    # before it, so the long-distance pre-pass overrides rows of 4-block
    # batches
    base = mixed_corpus(np.random.default_rng(31), 768 << 10).tobytes()
    far = b"".join(base[i * 3 * K: (i + 1) * 3 * K] + base[i * 3 * K:
                                                           i * 3 * K + K]
                   for i in range(4))
    round_robin_matches(monkeypatch, zstd(1, parser="linked"),
                        "_dispatch_parse", golden.zstd_decompress, data,
                        1 << 17)
    round_robin_matches(monkeypatch, zstd(4, parser="linked", block=K),
                        "_dispatch_parse", golden.zstd_decompress, far,
                        1 << 18, ldm=True)
    round_robin_matches(monkeypatch,
                        lambda w: LZ4Codec(device="cpu", max_batch_blocks=2,
                                           workers=w),
                        "_dispatch_batch", golden.lz4f_decompress, data,
                        1 << 17)


def test_dryrun_on_four_devices(monkeypatch):
    monkeypatch.setattr(udev, "_visible_devices", lambda dev: FOUR)
    with one_torch_thread():
        dryrun(4)
