"""ZstdCodec(parser="sort", device="cpu") against the JAX package's
ZstdCodec(parser="sort"): frames and decode hints byte-identical at
levels 1, 3 and 4 (64 KiB blocks), under entropy "auto" (the XLA arm)
and "smem" (K2), and decoded by stock libzstd.  The log-like frames keep
more than SMEM_SEQ_MAX sequences in a block, so their batches take the
XLA arm under both."""

import numpy as np
import pytest

from libzseek_tpu.format import hints as jax_hints
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
from libzseek_tpu.testing import golden
from libzseek_tpu.testing.corpus import mixed_corpus
from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.format import hints as port_hints
from libzseek_tpu_torch.testing.corpus import log_corpus
from test_torch_hash_inputs import Spy, with_repeat
from test_torch_inputs import build_native_runtime

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def _same_frames(vals, level, entropy, **more):
    kw = dict(level=level, parser="sort", entropy=entropy, **more)
    rf, rh = JCodec(**kw).compress_frames(vals, return_hints=True)
    gf, gh = ZstdCodec(device="cpu", **kw).compress_frames(
        vals, return_hints=True)
    for i, raw in enumerate(vals):
        assert gf[i] == rf[i], (level, entropy, more, i)
        assert port_hints.serialize([gh[i]]) == \
            jax_hints.serialize([rh[i]]), (level, entropy, i)
        assert golden.zstd_decompress(gf[i]) == raw, (level, entropy, i)
    return gh


def test_mixed_frames_on_both_arms(monkeypatch):
    """Mixed data with a long-distance repeat (the literal plane of its
    row from the host) and small frames: every batch keeps <= 4096
    sequences a block, so "smem" takes K2 and "auto" the XLA arm; then
    batches of at most 2 blocks without decode hints
    (max_batch_blocks=2, collect_hints=False)."""
    build_native_runtime()
    smem, xla = Spy(monkeypatch, "_entropy_smem"), \
        Spy(monkeypatch, "_entropy_xla")
    raw = mixed_corpus(np.random.default_rng(73), 1 << 17).tobytes()
    vals = [with_repeat(raw), b"abcabcabcabc" * 30, bytes(5000),
            b"x" * 200, b""]
    for level in (1, 3, 4):
        for entropy in ("auto", "smem"):
            before = smem.calls, xla.calls
            _same_frames(vals, level, entropy)
            arm = (smem.calls - before[0], xla.calls - before[1])
            assert arm == ((1, 0) if entropy == "smem" else (0, 1)), \
                (level, entropy, arm)
    before = smem.calls
    hints = _same_frames(vals, 3, "smem", max_batch_blocks=2,
                         collect_hints=False)
    assert smem.calls - before == 3 and all(h is None for f in hints
                                            for h in f)


def test_log_frames_on_the_xla_arm(monkeypatch):
    """Log-like lines: a 64 KiB block holds more than 4096 sequences
    after the gate, so both entropy settings take the XLA arm."""
    build_native_runtime()
    smem, xla = Spy(monkeypatch, "_entropy_smem"), \
        Spy(monkeypatch, "_entropy_xla")
    logs = log_corpus(np.random.default_rng(79), 70000).tobytes()
    vals = [logs, logs[:3000]]
    for level, entropy in ((3, "smem"), (3, "auto"), (1, "smem"),
                           (4, "auto")):
        _same_frames(vals, level, entropy)
    assert smem.calls == 0 and xla.calls == 4
