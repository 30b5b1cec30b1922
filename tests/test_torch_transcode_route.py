"""decode_frames_transcode (the port's transcode route, plain K4 and the
native host executor on the CPU) against the JAX package's decode_frames
down its transcode route and against the input: the cases of
tests/test_decode_smem.py (text, periodic, zeros, noise, tiny, one,
empty), a 1-stream Huffman text and the hand-written RLE frame by the
port's codec, with the host literals on and off (bytes; tolerance:
none)."""

import pytest

from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_transcode_inputs import capture_transcode, own_frames


def _routes(before):
    return {k: ZD.routes[k] - before[k] for k in before
            if k.startswith("transcode")}


@pytest.mark.parametrize("host_literals", [True, False],
                         ids=["host_literals", "device_literals"])
def test_transcode_route_port_frames(monkeypatch, host_literals):
    frames, raws = own_frames()
    sizes = [len(r) for r in raws]
    ref, calls = capture_transcode(monkeypatch, frames, sizes,
                                   host_literals=host_literals)
    before = dict(ZD.routes)
    got = ZD.decode_frames_transcode(frames, sizes,
                                     host_literals=host_literals, device="cpu")
    assert got == ref == raws
    assert calls and _routes(before) == {
        "transcode_batches": 1, "transcode_rule_batches": 0,
        "transcode_fallback_batches": 0}
