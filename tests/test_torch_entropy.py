"""K2: the plain version of the port's entropy kernel against the
reference Pallas kernel in interpret mode, and the plain K3 placement
(entropy.place_plain) on a hand-made case.

K2 (libzseek_tpu_torch/ops/entropy.entropy_emit) is held to
libzseek_tpu/ops/pallas_entropy.entropy_emit_smem over rows that cover
every literal mode (4-stream and 1-stream Huffman, raw literals, none)
and every sequence-table mode (predefined, RLE, FSE_Compressed at both
accuracy logs).  Inputs come from the port's own chain on numpy-seeded
data (that chain is held to the reference in test_torch_linked_post.py
and test_torch_plans.py).  Outputs are integer words and must be equal
(tolerance: none).  K3 against the reference: test_torch_vector_literals.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import pallas_entropy as jpe
from libzseek_tpu.testing.corpus import mixed_corpus
from libzseek_tpu_torch.convert import to_numpy
from libzseek_tpu_torch.ops import entropy as E
from test_torch_inputs import S, chain, planted, words


@pytest.fixture(scope="module")
def k2_rows():
    N = 16384
    rng = np.random.default_rng(31)
    rows = np.zeros((8, N), np.uint8)
    rows[0] = planted(rng, N)
    rows[1] = words(rng, N)
    rows[2] = np.tile(rng.choice(np.frombuffer(b"aaaabbbcd", np.uint8),
                                 150), N // 150 + 1)[:N]      # 1-stream
    noise = rng.integers(0, 256, N // 2, np.uint8)
    rows[3] = np.concatenate([noise, noise])                  # raw literals
    rows[4] = mixed_corpus(rng, 4 * N)[N: 2 * N]              # repeats
    rows[6] = words(rng, N)
    lens = np.array([N, N, N, N, N, N, 7000, 0], np.int32)
    rows[6, 7000:] = 0
    seqs, meta, codes, ctabs = chain(rows, lens)
    return rows, seqs, meta, codes, ctabs


def _k2(rows, seqs, meta, codes, ctabs):
    N = rows.shape[1]
    lit_cap = (N + 64 + 127) // 128 * 128
    seq_cap = (9 * S + 64 + 127) // 128 * 128
    ins = [seqs["ll"], seqs["ml"], seqs["offv"], meta, codes]
    ref = jpe.entropy_emit_smem(
        jnp.asarray(rows), *(jnp.asarray(a.numpy()) for a in ins), S,
        lit_cap, seq_cap,
        ctabs=None if ctabs is None else jnp.asarray(ctabs.numpy()),
        interpret=True)
    got = E.entropy_emit(torch.from_numpy(rows), *ins, S, lit_cap, seq_cap,
                         ctabs=ctabs)
    return ref, got


def test_entropy_matches_reference(k2_rows):
    """Per-block sequence tables as planned, then the same rows with every
    table forced to predefined."""
    rows, seqs, meta, codes, ctabs = k2_rows
    modes = meta[:, 3].numpy()
    seen = np.bitwise_or.reduce(modes)
    for bit in (E.MODE_HUF, E.MODE_HUF1, E.MODE_RAWLIT, E.MODE_SEQ,
                E.MODE_LL_FSE, E.MODE_OF_FSE, E.MODE_ML_FSE,
                E.MODE_OF_RLE, E.MODE_ML_RLE):
        assert seen & bit, (bit, modes)
    logs = {(int(m) >> E.MODE_LOG_SHIFT["ll"]) & 15 for m in modes}
    assert len(logs - {0}) == 2, logs          # both accuracy logs
    predef = meta.clone()
    predef[:, 3] &= 15
    names = ("lit_w", "seq_w", "osz", "lanch", "sanch")
    for tables, m, ct in (("per_block", meta, ctabs),
                          ("predefined", predef, None)):
        ref, got = _k2(rows, seqs, m, codes, ct)
        for name, r, g in zip(names, ref, got):
            r = np.asarray(r)
            np.testing.assert_array_equal(
                to_numpy(g, np.uint32 if r.dtype == np.uint32 else None), r,
                err_msg=f"{tables} {name}")


def test_place_literals_plain_ors_codes():
    # two codes straddling a word, sentinels of all four streams
    val = torch.tensor([[0b101, 0x7FF, 0]], dtype=torch.int64)
    pos = torch.tensor([[30, 40, -1]], dtype=torch.int64)
    sent = torch.tensor([[0, 64, -1, 70]], dtype=torch.int64)
    w = E.place_plain(val, pos, sent, 4).numpy().view(np.uint32)[0]
    expect = np.zeros(4, np.uint64)
    for v, p in ((0b101, 30), (0x7FF, 40), (1, 0), (1, 64), (1, 70)):
        big = int(v) << p
        for k in range(4):
            expect[k] |= (big >> (32 * k)) & 0xFFFFFFFF
    np.testing.assert_array_equal(w, expect.astype(np.uint32))
