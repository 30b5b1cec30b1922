"""decode_frames_transcode on frames of stock libzstd, against the JAX
package's decode_frames down its transcode route and the input: the
cases of tests/test_decode_smem.py at levels 1, 3 and 19 with a two-frame
batch of multi-block texts (test_decode_smem.py:77); and a level-19 frame
with a match ~400 KiB back (test_decode_smem.py:116), which the fused
execute arm's reference refuses (128 KiB ring) but whose offset the
transcode token holds: it must not fall back (bytes; tolerance: none)."""

import numpy as np

from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from test_torch_transcode_inputs import (capture_transcode, golden_batch,
                                         stock_frames)


def _decode(monkeypatch, frames, raws):
    sizes = [len(r) for r in raws]
    ref, calls = capture_transcode(monkeypatch, frames, sizes)
    before = dict(ZD.routes)
    got = ZD.decode_frames_transcode(frames, sizes, device="cpu")
    assert got == ref == raws and calls
    return {k: ZD.routes[k] - before[k] for k in before
            if k.startswith("transcode")}


def test_transcode_route_stock_frames(monkeypatch):
    frames, raws = stock_frames()
    g = golden_batch(np.random.default_rng(91))
    frames = frames[:-1] + [golden.zstd_compress(r, level=3) for r in g]
    routes = _decode(monkeypatch, frames, raws[:-1] + g)
    assert routes["transcode_batches"] == 1
    assert routes["transcode_fallback_batches"] == 0


def test_transcode_route_long_window_frame(monkeypatch):
    frames, raws = stock_frames()
    routes = _decode(monkeypatch, frames[-1:], raws[-1:])
    assert routes == {"transcode_batches": 1, "transcode_rule_batches": 0,
                      "transcode_fallback_batches": 0}
