"""The port's default zstd decode route, decoder="auto", against the JAX
package's decode_frames, which picks its route itself: on its
accelerator branch (ZN_DECODE_SMEM=force, interpret mode; the port's
"auto" takes that branch on every device) host delivery tries the
transcode route and leaves it for the fused decode where it refuses a
batch, by rule before its kernel or after a failed stat.  Four kinds of
frame: the port's own with their hints, the JAX codec's with its hints,
stock libzstd's, and 64 KiB-block frames of the port without hints
(the one the rule refuses, the one the stat refuses).  For each,
ZstdCodec(device="cpu") with no decoder returns the input, equal to the
JAX decode_frames (tolerance: none), and counts a transcode batch
exactly when the reference ran its transcode kernel and a batch sent
to the fused route exactly when the reference left its transcode route;
to_device=True takes the fused route and counts none.  The Reader and
open_reader default to the same route and load the hints sidecar."""

import io

import numpy as np
import torch

import libzseek_tpu_torch as port
from libzseek_tpu.format import hints as jax_hints
from libzseek_tpu.ops import pallas_decode as jpd
from libzseek_tpu_torch.format import hints as port_hints
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from test_torch_transcode_inputs import capture_transcode, cases, jax_frames

KIB = 1024


def _batches():
    """(name, frames, raws, port hints, JAX hints) per batch."""
    rng = np.random.default_rng(53)
    raws = list(cases(rng, 12 * KIB).values())
    frames, fh = port.ZstdCodec(device="cpu").compress_frames(
        raws, return_hints=True)
    jh = jax_hints.parse(port_hints.serialize(fh), 0)
    out = [("own", frames, raws, fh, jh)]
    frames, jh, ph = jax_frames(raws)
    out.append(("jax", frames, raws, ph, jh))
    out.append(("stock", [golden.zstd_compress(r, level=lv) for r, lv in
                          zip(raws, (1, 3, 19, 3, 1, 19, 3))],
                raws, None, None))
    wide = [mixed_corpus(rng, 160 * KIB).tobytes(),
            text_corpus(rng, 130 * KIB).tobytes()]
    frames = port.ZstdCodec(device="cpu", block=64 * KIB).compress_frames(
        wide)
    for i, name in enumerate(("64k rule", "64k stat")):
        out.append((name, frames[i: i + 1], wide[i: i + 1], None, None))
    return out


def _routes(before):
    return {k: ZD.routes[k] - before[k] for k in before
            if k.startswith("transcode")}


def test_default_route_matches_the_reference(monkeypatch):
    codec = port.ZstdCodec(device="cpu")
    assert codec.decoder == "auto"
    seen = set()
    for name, frames, raws, ph, jh in _batches():
        sizes = [len(r) for r in raws]
        ref, calls = capture_transcode(monkeypatch, frames, sizes, jh,
                                       fallback=True)
        arms = ["transcode" if (a[4][:, 0] & jpd.DMODE_TRANSCODE).all()
                else "execute" for a, _ in calls]
        ran = "transcode" in arms
        left = not ran or arms[-1] == "execute"
        before = dict(ZD.routes)
        got = codec.decompress_frames(frames, sizes, ph)
        assert got == ref == raws, name
        r = _routes(before)
        assert r["transcode_batches"] == int(ran), (name, arms, r)
        assert r["transcode_rule_batches"] + \
            r["transcode_fallback_batches"] == int(left), (name, arms, r)
        seen.add((ran, left))
        before = dict(ZD.routes)
        dev = codec.decompress_frames(frames, sizes, ph, to_device=True)
        assert all(isinstance(t, torch.Tensor) for t in dev)
        assert [t.numpy().tobytes() for t in dev] == raws, name
        assert set(_routes(before).values()) == {0}, name
    # the batches take each way: transcode alone, refused by rule, and
    # refused by the stat after the kernel
    assert seen == {(True, False), (False, True), (True, True)}, seen


def test_default_reader_and_open_reader(monkeypatch):
    data = mixed_corpus(np.random.default_rng(59), 384 * KIB).tobytes()
    sink = io.BytesIO()
    w = port.Writer(sink, device="cpu", min_frame_size=128 * KIB)
    for pos in range(0, len(data), 128 * KIB):
        w.write(data[pos: pos + 128 * KIB])
    w.close()
    archive = sink.getvalue()
    fused = []
    real = ZD.decode_frames
    monkeypatch.setattr(ZD, "decode_frames", lambda *a, **k: fused.append(
        k.get("to_device", False)) or real(*a, **k))
    for r in (port.Reader(archive, device="cpu"),
              port.open_reader(io.BytesIO(archive), device="cpu")):
        assert r._hints is not None and len(r._hints) == 3
        before = dict(ZD.routes)
        assert r.pread_full(len(data), 0) == data
        off = 200 * KIB
        assert r.pread_full(5000, off) == data[off: off + 5000]
        r.close()
        assert _routes(before)["transcode_batches"] >= 1
        assert _routes(before)["transcode_fallback_batches"] == 0
    assert fused == []
    # frames kept on the device take the fused route
    r = port.Reader(archive, device="cpu", device_cache=True)
    before = dict(ZD.routes)
    assert r.pread_full(len(data), 0) == data
    assert set(_routes(before).values()) == {0}
    assert fused and all(fused)
