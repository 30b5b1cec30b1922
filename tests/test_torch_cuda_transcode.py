"""K4's transcode arm (csrc/decode.cu zk_transcode) against its plain
version on the card, both arms (host and device literals), on small
frames, multi-row chains and variants of their calls, and the
transcode route of ZstdCodec (decoder="auto", host delivery) on "cuda"
against device="cpu".

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Tokens, literal words and stat are integers and must be equal
(tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from libzseek_tpu_torch.testing.damage import transcode_variants
from test_torch_cuda_inputs import (chain_stock_frames, cuda_device,
                                   leftover_bits_frame, own_frames,
                                   stock_frames)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _route_and_calls(monkeypatch, frames, raws, device, host_literals):
    calls = []
    real = D.transcode_blocks

    def spy(*a):
        out = real(*a)
        calls.append((a, out))
        return out

    monkeypatch.setattr(D, "transcode_blocks", spy)
    res = ZD.decode_frames_transcode(frames, [len(r) for r in raws],
                                     device=device,
                                     host_literals=host_literals)
    monkeypatch.setattr(D, "transcode_blocks", real)
    return res, calls


def _same_as_plain(args_cpu, dev):
    got = D.transcode_blocks(*[v.to(dev) if isinstance(v, torch.Tensor)
                               else v for v in args_cpu])
    ref = D.transcode_blocks(*args_cpu)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    return ref[2].numpy()


def test_transcode_kernel_matches_plain(monkeypatch, cuda):
    """Both arms (the Huffman literals on the host and on the card) on the
    small frames and on multi-row chains (repcodes carried from row to
    row), and the chains' calls varied (testing/damage.transcode_variants:
    damaged streams, a walk stopped mid-row, a WIDE entry, a row at its
    frame's start, a stream above the row walk's stage)."""
    f1, r1 = own_frames(device="cuda")
    f2, r2 = stock_frames()
    f3, r3 = chain_stock_frames()
    failed = 0
    for frames, raws, chains in ((f1 + f2, r1 + r2, False),
                                 (f3, r3, True)):
        for host_literals in (True, False):
            before = D.transcode_launches
            res, calls = _route_and_calls(monkeypatch, frames, raws, cuda,
                                          host_literals)
            assert res == raws and len(calls) == 1
            assert D.transcode_launches == before + 1
            a, out = calls[0]
            cpu = [v.cpu() if isinstance(v, torch.Tensor) else v for v in a]
            ref = D.transcode_blocks(*cpu)
            for x, y in zip(out, ref):
                np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
            assert (ref[2][:, 1] == 1).all()
            if chains:
                variants = transcode_variants(cpu, 3 + host_literals)
                assert {"stopped", "wide", "shifted",
                        "unstaged"} <= set(variants)
                for v in variants.values():
                    failed += not _same_as_plain(v, cuda)[:, 1].all()
    assert failed >= 8


def test_transcode_codec_matches_cpu(cuda):
    """Four 1 MiB frames of 8 blocks, one from each regime of the mixed
    corpus, with the codec's hints; and a corrupt frame raises."""
    data = mixed_corpus(np.random.default_rng(11), 16 << 20).tobytes()
    raws = [data[i << 22: (i << 22) + (1 << 20)] for i in range(4)]
    frames, fh = ZstdCodec(device="cuda").compress_frames(
        raws, return_hints=True)
    sizes = [len(r) for r in raws]
    before = dict(ZD.routes)
    got = ZstdCodec(device="cuda", decoder="auto").decompress_frames(
        frames, sizes, fh)
    cpu = ZstdCodec(device="cpu", decoder="auto").decompress_frames(
        frames, sizes, fh)
    assert got == cpu == raws
    assert ZD.routes["transcode_batches"] == before["transcode_batches"] + 2
    assert ZD.routes["transcode_fallback_batches"] == \
        before["transcode_fallback_batches"]
    bad, raw = leftover_bits_frame()
    with pytest.raises(FormatError):
        ZstdCodec(device="cuda", decoder="auto").decompress_frames(
            [bad], [len(raw)])
