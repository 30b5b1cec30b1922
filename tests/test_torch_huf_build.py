"""The port's native huf_build_batch (per-block literal Huffman tables of
the hash-parser path) against the JAX package's native one: lengths,
codes, serialized trees and max_bits (tolerance: none)."""

import numpy as np

from libzseek_tpu import native as jnative
from libzseek_tpu_torch import native
from test_torch_hash_inputs import skewed_hists
from test_torch_inputs import build_native_runtime


def test_huf_build_batch_matches_reference():
    """200 skewed histograms, plus an empty one, a one-symbol one (both
    degenerate, max_bits 0) and the uniform 256-symbol one (every weight
    equal: no FSE description and too many for the direct one, -1)."""
    build_native_runtime()
    special = np.zeros((3, 256), np.uint32)
    special[1, 7] = 5
    special[2] = 1
    hists = np.concatenate([skewed_hists(41, 200).astype(np.uint32),
                            special])
    got = native.huf_build_batch(hists)
    ref = jnative.huf_build_batch(hists)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]
    np.testing.assert_array_equal(got[3], ref[3])
    assert list(got[3][-3:]) == [0, 0, -1]
    assert (got[3][:200] > 0).all()
