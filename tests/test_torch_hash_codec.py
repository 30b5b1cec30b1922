"""ZstdCodec(parser="hash", device="cpu") against the JAX package's
ZstdCodec(parser="hash") (its K7 in interpret mode): frames and decode
hints byte-identical, decoded by stock libzstd, on both entropy arms."""

import numpy as np
import pytest

from libzseek_tpu.format import hints as jax_hints
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus
from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.format import hints as port_hints
from test_torch_hash_inputs import (N, Spy, interpret_k7, log_like,
                                    with_repeat)
from test_torch_inputs import build_native_runtime

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _same_frames(vals, **kw):
    rf, rh = JCodec(parser="hash", **kw).compress_frames(vals,
                                                        return_hints=True)
    gf, gh = ZstdCodec(device="cpu", parser="hash", **kw).compress_frames(
        vals, return_hints=True)
    for i, raw in enumerate(vals):
        assert gf[i] == rf[i], i
        assert port_hints.serialize([gh[i]]) == jax_hints.serialize([rh[i]])
        assert golden.zstd_decompress(gf[i]) == raw, i
    return gf


def test_mixed_frames_on_the_k2_arm(monkeypatch):
    """Mixed data (every regime: Huffman, raw, RLE and RLE-block rows),
    a long-distance repeat, small frames: every batch keeps <= 4096
    sequences a block and takes K2."""
    build_native_runtime()
    interpret_k7(monkeypatch)
    smem, xla = Spy(monkeypatch, "_entropy_smem"), \
        Spy(monkeypatch, "_entropy_xla")
    raw = mixed_corpus(np.random.default_rng(43), 2 * N).tobytes()
    _same_frames([with_repeat(raw), b"abcabcabcabc" * 30, bytes(5000),
                  b"x" * 200, b""])
    assert smem.calls == 1 and xla.calls == 0


def test_log_frames_on_the_xla_arm(monkeypatch):
    """Log-like data: blocks keep > 4096 sequences after the gate, so the
    batch takes the XLA arm (the literal plane, host tables)."""
    build_native_runtime()
    interpret_k7(monkeypatch)
    smem, xla = Spy(monkeypatch, "_entropy_smem"), \
        Spy(monkeypatch, "_entropy_xla")
    frames = _same_frames([with_repeat(log_like(47, N + 5000)),
                           log_like(53, 3000)])
    assert smem.calls == 0 and xla.calls == 1
    assert len(frames[0]) < (2 * N + 5000) // 2
