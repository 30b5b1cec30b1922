"""The transcode route on 64 KiB blocks (the block of levels >= 4).  The
reference takes every compressed block whose header gives no size for
128 KiB (zstd_decode.py:979), so its route falls back on such frames; the
port does too without hints, counted (by rule before the kernel where
the guessed sizes do not add up, after it where a block's size differs),
and still returns the input through the fused route.  With the Writer's
hints, usable or not, the port knows the frame is a Writer's, equal
blocks but the last, and takes the block its block count implies: no
fallback, also in a Reader over a level-4 archive (bytes; tolerance:
none)."""

import io

import numpy as np

import libzseek_tpu_torch as port
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus

KIB = 1024


def _routes(before):
    return {k: ZD.routes[k] - before[k] for k in before
            if k.startswith("transcode")}


def test_transcode_route_64k_blocks():
    rng = np.random.default_rng(37)
    raws = [mixed_corpus(rng, 160 * KIB).tobytes(),
            text_corpus(rng, 130 * KIB).tobytes()]
    frames, fh = port.ZstdCodec(device="cpu", block=64 * KIB) \
        .compress_frames(raws, return_hints=True)
    sizes = [len(r) for r in raws]
    # the Writer's hints, and the same with a block's record dropped (no
    # longer usable for mid-frame chunks, still the Writer's frame)
    cut = [list(f) for f in fh]
    cut[1][0] = None
    for hints in (fh, cut):
        before = dict(ZD.routes)
        assert ZD.decode_frames_transcode(frames, sizes, hints,
                                          device="cpu") == raws
        assert _routes(before) == {"transcode_batches": 1,
                                   "transcode_rule_batches": 0,
                                   "transcode_fallback_batches": 0}
    # without hints: the mixed frame's guessed sizes overrun it (the
    # fused route by rule, before the kernel); the text frame's add up
    # but its first block is not 128 KiB (the fused route after the
    # kernel's stat)
    for i, key in ((0, "transcode_rule_batches"),
                   (1, "transcode_fallback_batches")):
        before = dict(ZD.routes)
        assert ZD.decode_frames_transcode(frames[i:i + 1], sizes[i:i + 1],
                                          device="cpu") == raws[i:i + 1]
        assert _routes(before)[key] == 1


def test_reader_transcode_level4_archive():
    data = text_corpus(np.random.default_rng(41), 200 * KIB).tobytes()
    sink = io.BytesIO()
    w = port.Writer(sink, device="cpu", level=4, min_frame_size=136 * KIB)
    w.write(data)
    w.close()
    before = dict(ZD.routes)
    r = port.Reader(sink.getvalue(), device="cpu", decoder="auto")
    assert r.pread_full(len(data), 0) == data
    r.close()
    routes = _routes(before)
    assert routes["transcode_batches"] >= 1
    assert routes["transcode_fallback_batches"] == 0
