"""K2's CUDA phases (libzseek_tpu_torch/csrc/entropy.cu over
csrc/huf_place.cuh), mirrored in numpy by
testing/entropy_mirror.emit_mirror, against the plain version and
against the reference Pallas kernel
(libzseek_tpu/ops/pallas_entropy.entropy_emit_smem) in interpret mode.

The mirror follows the kernel's decomposition: the run table, each
literal chunk's code-length sum, then a block a chunk (the stream sizes
and bases from the sums, the scan of its threads' sums, which words a
thread stores and which it ORs, asserting that no stored word is touched
by another writer), and the sequence block's three state chains, its
scan of the widths and its rep1 max-scan.  Rows: 4-stream and 1-stream
Huffman, raw literals, none, per-block FSE and RLE tables at both
accuracy logs (the port's chain on numpy-seeded data, 16 KiB and 64 KiB
rows); crafted rows (lc = 0 and 1,003, streams under the anchor
interval, n = 0 and n = S, RLE ll and ml on predefined tables), at 16
KiB and 64 KiB.  Outputs are integer words and must be equal
(tolerance: none)."""

import numpy as np
import torch

import jax.numpy as jnp

from libzseek_tpu.ops import pallas_entropy as jpe
from libzseek_tpu_torch.convert import to_numpy
from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.testing import entropy_mirror as M
from test_torch_cuda_inputs import k2_edge_rows
from test_torch_inputs import S, k2_chain_rows

NAMES = ("lit_w", "seq_w", "osz", "lanch", "sanch")


def _three_ways(x, ll, ml, off, meta, codes, S_, ctabs, tag):
    N = x.shape[1]
    lit_cap = (N + 64 + 127) // 128 * 128
    seq_cap = (9 * S_ + 64 + 127) // 128 * 128
    ins = (ll, ml, off, meta, codes)
    ref = jpe.entropy_emit_smem(
        jnp.asarray(x.numpy()), *(jnp.asarray(a.numpy()) for a in ins), S_,
        lit_cap, seq_cap,
        ctabs=None if ctabs is None else jnp.asarray(ctabs.numpy()),
        interpret=True)
    plain = E.entropy_emit(x, *ins, S_, lit_cap, seq_cap, ctabs=ctabs)
    mirror = M.emit_mirror(x, *ins, S_, lit_cap, seq_cap, ctabs=ctabs)
    for name, r, p, m in zip(NAMES, ref, plain, mirror):
        r = np.asarray(r)
        as_ref = np.uint32 if r.dtype == np.uint32 else None
        np.testing.assert_array_equal(to_numpy(m, as_ref), r,
                                      err_msg=f"{tag} {name} (reference)")
        np.testing.assert_array_equal(m.numpy(), p.numpy(),
                                      err_msg=f"{tag} {name} (plain)")


def test_k2_mirror_chain_rows():
    """The chain's rows with their per-block tables, the same rows with
    every table predefined, and two 64 KiB rows."""
    rows, seqs, meta, codes, ctabs = k2_chain_rows()
    modes = np.bitwise_or.reduce(meta[:, 3].numpy())
    for bit in (E.MODE_HUF, E.MODE_HUF1, E.MODE_RAWLIT, E.MODE_LL_FSE,
                E.MODE_OF_RLE, E.MODE_ML_RLE):
        assert modes & bit, bit
    x = torch.from_numpy(rows)
    sq = (seqs["ll"], seqs["ml"], seqs["offv"])
    _three_ways(x, *sq, meta, codes, S, ctabs, "per-block tables")
    predef = meta.clone()
    predef[:, 3] &= 15
    _three_ways(x, *sq, predef, codes, S, None, "predefined tables")
    rows, seqs, meta, codes, ctabs = k2_chain_rows(N=65536, seed=37)
    keep = [0, 2]     # planted matches (891 sequences), one stream
    _three_ways(torch.from_numpy(rows[keep]),
                *(seqs[k][keep] for k in ("ll", "ml", "offv")), meta[keep],
                codes[keep], S, ctabs[keep], "64 KiB rows")


def test_k2_mirror_crafted_rows():
    for N, seed in ((16384, 53), (65536, 61)):
        x, ll, ml, off, meta, codes, S_ = k2_edge_rows(N, seed=seed)
        lc, n = meta[:, 1].tolist(), meta[:, 2].tolist()
        assert 0 in lc and 1003 in lc and 0 in n and S_ in n
        _three_ways(x, ll, ml, off, meta, codes, S_, None, f"crafted {N}")
