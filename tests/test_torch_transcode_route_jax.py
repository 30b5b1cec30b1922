"""decode_frames_transcode on frames of the JAX package's codec (its CPU
default parser) with the hints it publishes: the cases of
tests/test_decode_smem.py and its 300 KiB three-block frame, against the
JAX decode_frames down its transcode route and the input; and without
hints (bytes; tolerance: none)."""

import numpy as np

from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_transcode_inputs import (capture_transcode, cases,
                                         jax_frames, multiblock)


def test_transcode_route_jax_frames(monkeypatch):
    rng = np.random.default_rng(91)
    raws = list(cases(rng).values()) + [multiblock(rng)]
    frames, jh, ph = jax_frames(raws)
    sizes = [len(r) for r in raws]
    ref, calls = capture_transcode(monkeypatch, frames, sizes, jh)
    before = ZD.routes["transcode_fallback_batches"]
    assert ZD.decode_frames_transcode(frames, sizes, ph,
                                      device="cpu") == ref == raws
    assert ZD.decode_frames_transcode(frames, sizes, device="cpu") == raws
    assert calls and ZD.routes["transcode_fallback_batches"] == before
