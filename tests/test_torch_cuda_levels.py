"""K1's level >= 4 arms on the card against their plain versions, and the
level-9 codec on the card against device="cpu".

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are integer words and frame bytes and must be equal (tolerance:
none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.ops.parse_linked import parse_linked
from libzseek_tpu_torch.ops.zstd_encode import (block_entropy_h16,
                                                level_search_params)
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import arms_rows, cuda_device, same

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _batches():
    """The crafted rows of each arm (lazy win, short4, repcode probe,
    period data), and 16 rows of 64 KiB from a mixed corpus in frames of
    four blocks."""
    N = 1 << 16
    data = mixed_corpus(np.random.default_rng(61), 16 * N)
    x2 = np.zeros((17, N), np.uint8)
    x2[1:] = data.reshape(16, N)
    i = np.arange(16)
    min_abs = np.where(i % 4 == 0, (i + 1) * N, i * N).astype(np.int32)
    return [arms_rows(), (x2, np.full(16, N, np.int32), min_abs)]


def test_k1_level_arms_match_plain(cuda):
    for x2, lens, min_abs in _batches():
        args = [torch.from_numpy(a) for a in (x2, lens, min_abs)]
        h16, _ = block_entropy_h16(args[0][1:], args[1])
        args.append(h16)
        for level in (4, 9, 16):
            prm = level_search_params(level)
            got = parse_linked(*(a.to(cuda) for a in args), **prm)
            same(got, parse_linked(*args, **prm))


def test_level9_codec_frames_match_plain(cuda):
    """A mixed frame of five 64 KiB blocks and a short one, through both
    parsers."""
    raws = [mixed_corpus(np.random.default_rng(67), 5 * 65536).tobytes(),
            mixed_corpus(np.random.default_rng(71), 3000).tobytes()]
    for parser in ("linked", "hash"):
        got = ZstdCodec(level=9, device="cuda", parser=parser) \
            .compress_frames(raws)
        ref = ZstdCodec(level=9, device="cpu", parser=parser) \
            .compress_frames(raws)
        assert got == ref, parser
