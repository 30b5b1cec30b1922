"""decode_frames_lanes against the JAX package's decode_frames on frames
of stock libzstd (no sidecar: the plain lanes): levels 1, 3 and 19 with
every table mode, through K6; and a long-window level-19 frame whose
match ~400 KiB back is past K6's limit, through the pointer-doubling
executor (tolerance: none, bytes)."""

from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_lanes_inputs import (NO_TRANSCODE, stock_frames,
                                     zstd_level_frames)


def _both(monkeypatch, frames, raws):
    monkeypatch.setenv("ZN_DECODE_SMEM", "off")
    sizes = [len(r) for r in raws]
    ref = JZ.decode_frames(frames, sizes)
    before = dict(ZD.routes)
    got = ZD.decode_frames_lanes(frames, sizes, device="cpu")
    assert got == ref == raws
    return {k: ZD.routes[k] - before[k] for k in before}


def test_decode_frames_lanes_stock_frames(monkeypatch):
    frames, raws = stock_frames()
    lf, lr = zstd_level_frames()
    routes = _both(monkeypatch, frames[:-1] + lf, raws[:-1] + lr)
    assert routes == {"anchored_frames": 0, "plain_frames": len(lf) + 18,
                      "k6_batches": 1, "pointer_doubling_batches": 0,
                      **NO_TRANSCODE}


def test_decode_frames_lanes_long_window_frame(monkeypatch):
    frames, raws = stock_frames()
    routes = _both(monkeypatch, frames[-1:], raws[-1:])
    assert routes == {"anchored_frames": 0, "plain_frames": 1,
                      "k6_batches": 0, "pointer_doubling_batches": 1,
                      **NO_TRANSCODE}
