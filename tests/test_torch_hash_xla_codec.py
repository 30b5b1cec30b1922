"""ZstdCodec(entropy="xla", device="cpu") with either parser against the
JAX package's ZstdCodec(entropy="xla"): every batch takes the XLA arm
(literal plane, host Huffman tables, FSE with the predefined tables);
frames and decode hints byte-identical and decoded by stock libzstd."""

import numpy as np
import pytest

from libzseek_tpu.format import hints as jax_hints
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.format import hints as port_hints
from test_torch_hash_inputs import (N, Spy, interpret_k7, log_like,
                                    with_repeat)
from test_torch_inputs import build_native_runtime

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _same_frames(monkeypatch, parser, vals):
    build_native_runtime()
    xla = Spy(monkeypatch, "_entropy_xla")
    rf, rh = JCodec(parser=parser, entropy="xla").compress_frames(
        vals, return_hints=True)
    gf, gh = ZstdCodec(device="cpu", parser=parser, entropy="xla") \
        .compress_frames(vals, return_hints=True)
    for i, raw in enumerate(vals):
        assert gf[i] == rf[i], i
        assert port_hints.serialize([gh[i]]) == jax_hints.serialize([rh[i]])
        assert golden.zstd_decompress(gf[i]) == raw, i
    assert xla.calls == 1


def test_hash_parser_xla_arm(monkeypatch):
    """Mixed data with a long-distance repeat (its literal row comes from
    the host plane), log-like lines, a tiny and an RLE frame."""
    interpret_k7(monkeypatch)
    raw = mixed_corpus(np.random.default_rng(59), N + 9000).tobytes()
    _same_frames(monkeypatch, "hash", [with_repeat(raw),
                                       log_like(61, 20000), b"q" * 3000,
                                       b"abc"])


def test_linked_parser_xla_arm(monkeypatch):
    """The linked parse (K1) finished by the XLA arm instead of the
    device chain: a text-and-mixed frame and a log-like frame."""
    rng = np.random.default_rng(67)
    _same_frames(monkeypatch, "linked", [
        text_corpus(rng, 12000).tobytes() + mixed_corpus(rng, 24000)
        .tobytes(), log_like(71, 16000)])
