"""K4's transcode arm as its CUDA kernels run it (csrc/decode.cu
tc_walk_kernel and tc_chain_kernel; their numpy mirror
ops/decode.transcode_mirror): every row walked at once with the sequence
lanes' windowed step and its repcodes symbolic, each chain's repcode
transforms composed in order, every symbolic offset resolved and checked.
Held to the plain walk (ops/decode.transcode_blocks on CPU tensors) and
to the reference kernel (pallas_decode._decode_kernel, interpret mode) on
the rows the JAX transcode route builds: multi-block chains whose
repcodes carry from row to row (host literals) and stock and own frames
(device literals); then to the plain walk on variants of the port's
calls (testing/damage.transcode_variants): damaged streams (rows failing
mid-row, offsets out of range), an offset code above 31 (the walk
stopped mid-row), a WIDE entry, a row placed at its frame's start, a
stream above the walk's stage.  Stat, tokens and literal words:
tolerance none."""

import numpy as np
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.testing.corpus import log_corpus
from libzseek_tpu_torch.testing.damage import transcode_variants
from test_torch_transcode_inputs import (capture_transcode, chain_frames,
                                         check_rows, own_frames, port_args,
                                         stock_frames, transcode_args)

KIB = 1024


def _mirror_is_plain(args, stats) -> np.ndarray:
    """The mirror's outputs equal the plain walk's; returns the stat."""
    ref = D.transcode_blocks(*args)
    got = D.transcode_mirror(*args, stats=stats)
    for name, x, y in zip(("lits", "toks", "stat"), got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)
    return ref[2].numpy()


def test_mirror_matches_plain_and_reference(monkeypatch):
    stats = {}
    chain, chain_raws = chain_frames(np.random.default_rng(91))
    f1, r1 = own_frames()
    f2, r2 = stock_frames()
    for frames, raws, host_literals in ((chain, chain_raws, True),
                                        (f1 + f2, r1 + r2, False)):
        res, calls = capture_transcode(monkeypatch, frames,
                                       [len(r) for r in raws],
                                       host_literals=host_literals)
        assert res == raws
        for a, _ in calls:
            assert (_mirror_is_plain(port_args(a), stats)[:, 1] == 1).all()
        assert check_rows(calls, D.transcode_mirror) == \
            sum(len(a[4]) for a, _ in calls)
    # repcodes the rows inherit: offsets left symbolic to the chain phase
    assert stats["symbolic"] > 100 and stats["steps"] > 2000, stats


def test_mirror_matches_plain_on_variants():
    chain, raws = chain_frames(np.random.default_rng(91))
    logs = log_corpus(np.random.default_rng(13), 96 * KIB).tobytes()
    parts = [logs[: 48 * KIB], logs[48 * KIB:]]
    lf, fh = ZstdCodec(device="cpu", block=16 * KIB).compress_frames(
        parts, return_hints=True)
    calls = [transcode_args(chain, [len(r) for r in raws]),
             transcode_args(lf, [len(p) for p in parts], fh, False)]
    stats, failed, mid = {}, 0, 0
    for i, args in enumerate(calls):
        assert (_mirror_is_plain(args, stats)[:, 1] == 1).all()
        for name, v in transcode_variants(args, 5 + i).items():
            stat = _mirror_is_plain(v, stats)
            bad = np.nonzero(stat[:, 1] == 0)[0]
            failed += bool(len(bad))
            mid += name == "stopped" and bool(len(bad)) and stat[bad[0], 0] > 0
    assert stats["stops"] >= 2 and stats["wide_steps"] > stats["stops"]
    assert stats["unstaged_rows"] >= 2 and stats["symbolic"] > 100
    assert failed >= 8 and mid >= 1, (failed, mid)
