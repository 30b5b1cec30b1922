"""The port's native host library (libzseek_tpu_torch/native): built once
per process into build/torch_native/ under a name hashed from its source,
and its three entry points against the reference: XXH64 against the JAX
package's xxhash, tree descriptions that read back to their weights, and
the long-distance scan on a planted whole-block repeat."""

import os

import numpy as np

from libzseek_tpu.format.xxhash import xxh64 as jax_xxh64
from libzseek_tpu.ops import huffman as jhuf
from libzseek_tpu_torch import native
from libzseek_tpu_torch.ops import huffman


def test_library_builds_once_and_hashes():
    lib = native.library()
    assert native.library() is lib
    name = os.path.basename(lib._name)
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert name.startswith("libzseek_torch_native_") and name.endswith(".so")
    rng = np.random.default_rng(31)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 4096, 100_003):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        assert native.xxh64(data) == jax_xxh64(data), n
        assert native.xxh64(data, 7) == jax_xxh64(data, 7), n


def test_tree_descriptions_and_long_distance_scan():
    rng = np.random.default_rng(32)
    weights = np.zeros((6, 256), np.uint8)
    # Kraft-exact weights: 2^(w-1) summing to a power of two
    weights[0, [0, 1]] = 1
    weights[1, :3] = [2, 1, 1]
    weights[2, :128] = 1
    weights[2, 128:192] = 2
    for i, n in ((3, 5), (4, 60), (5, 120)):
        counts = np.zeros(256, np.int64)      # the reference's Huffman code
        counts[rng.choice(256, n, replace=False)] = \
            1 + (rng.pareto(1.0, n) * 40).astype(np.int64)
        weights[i] = jhuf.build_ctable(counts).weights
    trees = native.huf_tree_batch(weights)
    for i, t in enumerate(trees):
        assert t is not None, i
        got, used = huffman.read_weights(t, 0)
        assert used == len(t)
        np.testing.assert_array_equal(got, weights[i, : len(got)])
        assert not weights[i, len(got):].any()
    # block 3 of the batch repeats block 0, 3 * 64 KiB back
    bs = 1 << 16
    x = rng.integers(0, 256, 4 * bs, np.uint8)
    x[3 * bs:] = x[:bs]
    d = native.ldm_scan(x, 4, bs, np.zeros(4, np.int64),
                        np.full(4, bs, np.int32), 1 << 17)
    np.testing.assert_array_equal(d[3], [3 * bs, 0, bs])
    assert not d[:3, 0].any()
