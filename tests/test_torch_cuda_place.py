"""K3's fused CUDA route against its plain version on the card.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.  Outputs
are integer words and must be equal (tolerance: none)."""

import pytest
import torch

from libzseek_tpu_torch.ops import vector_entropy as VE
from test_torch_cuda_inputs import LIT_CAP, cuda_device, mixed_batch
from test_torch_cuda_inputs import same as _same

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


@pytest.fixture(scope="module")
def batch():
    return mixed_batch()


def test_placement_kernel_matches_plain(cuda, batch):
    """The fused K3 call on every row of the mixed batch (all four
    regimes, each taken as a K3 row) against its plain version."""
    x2, lens, _, seqs, _meta, codes, _ = batch
    vec = torch.ones(len(lens), dtype=torch.bool)
    args = (torch.from_numpy(x2[1:]), seqs["lit_mask"], codes,
            torch.from_numpy(lens), vec)
    plain = VE.vector_literals(*args, LIT_CAP)
    card = VE.vector_literals(*(a.to(cuda) for a in args), LIT_CAP)
    _same(card, plain)
