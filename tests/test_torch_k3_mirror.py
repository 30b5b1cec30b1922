"""K3's fused CUDA route (libzseek_tpu_torch/csrc/place_literals.cu over
csrc/huf_place.cuh), mirrored in numpy by
testing/entropy_mirror.vector_mirror, against the plain version and against
the reference libzseek_tpu/ops/vector_entropy.vector_literals (its
Pallas kernel in interpret mode).

The mirror follows the kernels' phases: each mask word cut to the row's
length, the word ranks from their popcounts, each literal's byte by the
rank search and a select within its word, the chunk sums, then the
chunked placement shared with K2's literal half (asserting that no word a
thread stores is touched by another writer).  Rows: the port's chain on
numpy-seeded 128 KiB rows (a row cut short, a row K3 does not take), and
crafted coverage masks (every byte a literal, 3/4, 1/2, a length inside a
word, 1,500 literals: streams under the anchor interval).  Outputs are
integer words and must be equal (tolerance: none)."""

import numpy as np
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import vector_entropy as jve
from libzseek_tpu_torch.convert import to_numpy
from libzseek_tpu_torch.ops import vector_entropy as VE
from libzseek_tpu_torch.testing import entropy_mirror as M
from test_torch_cuda_inputs import k3_edge_rows
from test_torch_inputs import k3_chain_rows

LIT_CAP = (VE.N_BLOCK + 64 + 127) // 128 * 128


def _three_ways(x, mask, codes, lens, vec, tag):
    args = (x, mask, codes, lens, vec, LIT_CAP)
    ref = jve.vector_literals(*(jnp.asarray(a.numpy()) for a in args[:5]),
                              LIT_CAP, interpret=True)
    plain = VE.vector_literals(*args)
    mirror = M.vector_mirror(*args)
    for name, r, p, m in zip(("words", "sizes", "lanch"), ref, plain,
                             mirror):
        r = np.asarray(r)
        as_ref = np.uint32 if r.dtype == np.uint32 else None
        np.testing.assert_array_equal(to_numpy(m, as_ref), r,
                                      err_msg=f"{tag} {name} (reference)")
        np.testing.assert_array_equal(m.numpy(), p.numpy(),
                                      err_msg=f"{tag} {name} (plain)")


def test_k3_mirror_chain_rows():
    rows, lens, seqs, codes, vec = k3_chain_rows()
    _three_ways(torch.from_numpy(rows), seqs["lit_mask"], codes,
                torch.from_numpy(lens), vec, "chain rows")


def test_k3_mirror_crafted_rows():
    _three_ways(*k3_edge_rows(), "crafted rows")
