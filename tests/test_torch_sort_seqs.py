"""The sort parser's zstd_sequences (libzseek_tpu_torch/ops/
zstd_encode.py: the match pipeline, the entropy gate through
gate_entropy, the greedy_select plain version, run merging, repcodes
and the literal plane) against the JAX package's, key for key, at the
codec's segment sizes (4 and 8, extension 48 and 32), on 128 KiB rows
of mixed data, text, log-like lines (> 4096 sequences) and a short row
(tolerance none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu_torch.ops import zstd_encode as ze
from test_torch_sort_inputs import block_rows


def test_zstd_sequences_match_jax():
    X, lens = block_rows()
    for seg_size, max_len in ((4, 48), (8, 32)):
        ref = jze.zstd_sequences(jnp.asarray(X), jnp.asarray(lens),
                                 seg_size=seg_size, max_len=max_len)
        got = ze.zstd_sequences(torch.from_numpy(X), torch.from_numpy(lens),
                                seg_size=seg_size, max_len=max_len)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=f"{seg_size} {k}")
        assert int(got["n_seq"][2]) > 4096
