"""The lane route's Huffman tables: the port builds them on the device
(build_dtabs, torch ops), the reference's lanes on the host
(_HufReg.packed, :98-107).  They are equal on every table of the port's
and libzstd's frames and on hand-made weights of every table log up to
libzstd's 12 (tolerance: none)."""

import numpy as np
import torch

from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_lanes_inputs import (jax_huf_tables, kraft_weights,
                                     own_frames, parse, stock_frames,
                                     zstd_level_frames)


def test_build_dtabs_equals_reference_packed_tables():
    frames = own_frames()[0] + stock_frames()[0] + zstd_level_frames()[0]
    _, hufreg, _ = parse(frames)
    n_frames = len(hufreg.weights)
    rng = np.random.default_rng(47)
    for tl in range(1, 13):
        for _ in range(4):
            hufreg.add(kraft_weights(rng, tl))
    assert n_frames >= 4 and set(hufreg.tls) == set(range(1, 13))
    W, TLS = hufreg.weights_arr()
    got = ZD.build_dtabs(torch.from_numpy(W), torch.from_numpy(TLS))
    np.testing.assert_array_equal(got.numpy(), jax_huf_tables(hufreg))
