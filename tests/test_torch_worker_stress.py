"""Eight zstd worker pipelines on the one CPU device, more workers than
this test lets torch use threads, with the interpreter switching threads
every microsecond: the adaptive payload cap that every worker reads and
updates (ZstdCodec._cap_hint, _needs) and the per-device constant tables
take no torn update, so the archive still equals workers=1's and every
batch is counted once."""

import sys

from test_torch_worker_pipelines import make, plain_decode, write
from test_torch_workers import K, mixed_512k, one_torch_thread


def test_eight_workers_under_fast_switching():
    data = mixed_512k()[: 7 * K]
    with one_torch_thread():
        one, _ = write(make(1), data)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            codec = make(8)
            eight, w = write(codec, data)
        finally:
            sys.setswitchinterval(interval)
    assert eight == one and plain_decode(eight) == data
    assert w._stream.worker_batches == [1] * 7 + [0] and codec._rr == 7
    assert len(codec._needs) == 8 and codec._cap_hint is not None
