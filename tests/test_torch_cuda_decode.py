"""K4's CUDA kernel against its plain version on the card.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.  Outputs
are bytes and integer flags and must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import (cuda_device, leftover_bits_frame,
                                   own_frames, stock_frames)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _both(frames, raws, cuda):
    """K4 on the card and its plain version on the CPU, same rows."""
    sizes = [len(r) for r in raws]
    args, n, rows = ZD.k4_inputs(frames, sizes, cuda)
    out, stat = D.decode_blocks(*args, n, n_seqs=D.seq_total(rows["meta"]))
    p_out, p_stat = D.decode_blocks(*[a.cpu() for a in args], n)
    return (out.cpu().numpy(), stat.cpu().numpy(), p_out.numpy(),
            p_stat.numpy())


def test_decode_kernel_matches_plain_small(cuda):
    frames, raws = own_frames(device="cuda")
    sf, sr = stock_frames()
    frames, raws = frames + sf, raws + sr
    out, stat, p_out, p_stat = _both(frames, raws, cuda)
    np.testing.assert_array_equal(stat, p_stat)
    assert (stat[:, 1] == 1).all()
    assert out.tobytes() == p_out.tobytes() == b"".join(raws)


def test_decode_kernel_matches_plain_frames(cuda):
    """Four 1 MiB frames of 8 blocks, one from each regime of the mixed
    corpus; and a corrupt frame raises."""
    data = mixed_corpus(np.random.default_rng(11), 16 << 20).tobytes()
    raws = [data[i << 22: (i << 22) + (1 << 20)] for i in range(4)]
    frames = ZstdCodec(device="cuda").compress_frames(raws)
    out, stat, p_out, p_stat = _both(frames, raws, cuda)
    np.testing.assert_array_equal(stat, p_stat)
    assert out.tobytes() == p_out.tobytes() == b"".join(raws)
    got = ZD.decode_frames(frames, [len(r) for r in raws], to_device=True,
                           device=cuda)
    assert all(isinstance(g, torch.Tensor) and g.is_cuda for g in got)
    bad, raw = leftover_bits_frame()
    with pytest.raises(FormatError):
        ZD.decode_frames([bad], [len(raw)], device=cuda)
