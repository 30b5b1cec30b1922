"""The hash gate's entropy H against the reference's XLA expression, bit
for bit (tolerance: none).  The gate keeps a sequence when ml * H
exceeds an integer cost in float32, so one ulp of H can flip it: the
port computes H on the host (native zn_gate_entropy) with XLA's float
operations, order of summation and log polynomial."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.testing.corpus import mixed_corpus
from libzseek_tpu_torch.ops import common as C
from libzseek_tpu_torch.ops.zstd_encode import gate_entropy
from test_torch_hash_inputs import (N, block_rows, log_like, skewed_hists,
                                    small_rows, xla_gate_entropy)


def _row_hists():
    """Byte histograms of every row the hash tests make: the 16 KiB and
    128 KiB rows, the codec tests' blocks, and their prefixes."""
    X, lens = small_rows()
    Y, ylens = block_rows()
    rows = [(x, int(n)) for x, n in zip(X, lens)]
    rows += [(y, int(n)) for y, n in zip(Y, ylens)]
    data = np.frombuffer(log_like(23, 3 * N) + mixed_corpus(
        np.random.default_rng(29), 4 * N).tobytes(), np.uint8).copy()
    rows += [(data[i: i + N], N) for i in range(0, len(data), N)]
    rows += [(x[:n], n) for x, _ in rows[:8] for n in (100, 1000, 5000)]
    hists = []
    for x, n in rows:
        t = torch.from_numpy(np.ascontiguousarray(x[None, :]))
        inr = torch.arange(t.shape[1])[None, :] < n
        hists.append(C.hist256(t, inr)[0].numpy())
    return np.stack(hists)


def _check(hists):
    got = gate_entropy(torch.from_numpy(hists)).numpy()
    ref = np.asarray(xla_gate_entropy(jnp.asarray(hists)))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_gate_entropy_on_test_rows():
    hists = _row_hists()
    assert len(hists) > 30
    _check(hists)


def test_gate_entropy_on_skewed_histograms():
    """200 seeded Zipf-like histograms, 1 to 256 symbols."""
    hists = skewed_hists(31, 200)
    _check(hists)
    assert len(np.unique(gate_entropy(torch.from_numpy(hists)))) > 150
