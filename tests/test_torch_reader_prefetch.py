"""Reader.prefetch and Reader(codec=...) in the port (libzseek_tpu_torch/
runtime/reader.py), as the JAX package's Reader has them
(libzseek_tpu/runtime/reader.py:41, :154-186): prefetch decodes the
uncached frames covering a list of offsets in one codec call, with the
decode hints and device delivery the reader uses, and never deadlocks
with a concurrent read(); codec= takes any object with
decompress_frames."""

import functools
import io
import threading

import numpy as np
import pytest

from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu.testing import golden
from libzseek_tpu_torch import Reader, Writer, ZstdCodec
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.testing.corpus import mixed_corpus

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")

FRAME = 1 << 15


@functools.lru_cache(maxsize=None)
def _archive():
    """12 frames of 32 KiB of mixed data (seed 107), sort parser."""
    data = mixed_corpus(np.random.default_rng(107), 12 * FRAME).tobytes()
    buf = io.BytesIO()
    with Writer(buf, ZstdCodec(device="cpu", parser="sort"),
                min_frame_size=FRAME, batch_frames=12) as w:
        for pos in range(0, len(data), FRAME):
            w.write(data[pos: pos + FRAME])
    return data, buf.getvalue()


def _count_calls(r):
    calls = []
    orig = r._codec.decompress_frames

    def counted(datas, d_sizes, *args, **kw):
        calls.append((len(datas), len(args), kw.get("to_device", False)))
        return orig(datas, d_sizes, *args, **kw)
    r._codec.decompress_frames = counted
    return calls


def test_prefetch_one_call_and_no_deadlock():
    data, arch = _archive()
    offs = [0, 5, 2 * FRAME + 7, 5 * FRAME, 5 * FRAME + 100, 11 * FRAME,
            len(data), len(data) + 10]
    # the default route ("auto") and "lanes" pass the sidecar's hints,
    # "fused" none
    for kw, hints, device in (({}, 1, False),
                              ({"decoder": "fused"}, 0, False),
                              ({"decoder": "lanes"}, 1, False),
                              ({"device_cache": True}, 1, True)):
        r = Reader(arch, device="cpu", **kw)
        calls = _count_calls(r)
        r.prefetch(offs)
        assert calls == [(4, hints, device)], kw
        st = r.stats()
        assert st.cache_entries == 4
        for off in offs[:6]:
            assert r.pread(16, off) == data[off: off + 16]
        assert r.stats().cache_hits == st.cache_hits + 6 and len(calls) == 1
        r.prefetch(offs[:3] + [7 * FRAME])
        assert calls[1:] == [(1, hints, device)], kw
        r.close()
    r = Reader(arch, device="cpu", cache_frames=0)
    calls = _count_calls(r)
    r.prefetch(offs)
    assert calls == [(4, 1, True)]
    # a sequential read (its prefetch windows on the reader's threads)
    # beside prefetch calls from another thread
    r = Reader(arch, device="cpu", cache_frames=4, readahead=2)
    got, errors = [], []

    def reader():
        try:
            while chunk := r.read(5000):
                got.append(chunk)
        except Exception as e:    # reported below
            errors.append(e)

    def prefetcher():
        try:
            rng = np.random.default_rng(109)
            for _ in range(20):
                r.prefetch(rng.integers(0, len(data), 3).tolist())
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (reader, prefetcher)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads), "deadlock"
    assert not errors and b"".join(got) == data
    r.close()


class _StockZstd:
    """A codec of stock libzstd calls: decompress_frames only."""

    def __init__(self):
        self.calls = 0

    def decompress_frames(self, datas, d_sizes):
        self.calls += 1
        return [golden.zstd_frame_decompress(d, n)
                for d, n in zip(datas, d_sizes)]


def test_reader_takes_a_codec():
    """A stock-libzstd codec (no hints, no device frames even with
    device_cache) and the JAX package's ZstdCodec (hints passed) serve
    the port's Reader; an object without decompress_frames is refused."""
    data, arch = _archive()
    stock = _StockZstd()
    r = Reader(arch, device="cpu", codec=stock, device_cache=True)
    assert r.pread_full(len(data), 0) == data and stock.calls > 0
    r.prefetch([0, 3 * FRAME])
    assert isinstance(r._cache.find(0), bytes)
    r = Reader(arch, device="cpu", codec=JCodec(), cache_frames=2)
    calls = _count_calls(r)
    off = 9 * FRAME + 11
    assert r.pread_full(3 * FRAME, off) == data[off: off + 3 * FRAME]
    assert calls and all(c[1] == 1 for c in calls)
    with pytest.raises(ParameterError):
        Reader(arch, device="cpu", codec=object())
