"""K4's phased execute arm on the card (csrc/decode.cu: the literal
section from shared memory, per-row records with symbolic repcodes, the
frames' composition and checks, execution by scatter and pointer
doubling) against its plain version: the port's and stock libzstd's
small frames, a long-window frame, damaged rows and frames (failing
mid-row, stat and bytes up to the failing sequence), and 8 level-3 and
8 level-9 frames of the mixed corpus.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are bytes and integer flags and must be equal (tolerance:
none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from libzseek_tpu_torch.testing.damage import damaged_frames, damaged_rows
from test_torch_cuda_inputs import cuda_device, own_frames, stock_frames

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _both(args, n, n_seqs, cuda):
    """The kernel on the card and the plain version on the CPU: stat."""
    out, stat = D.decode_blocks(*[a.to(cuda) for a in args], n,
                                n_seqs=n_seqs)
    p_out, p_stat = D.decode_blocks(*[a.cpu() for a in args], n)
    np.testing.assert_array_equal(stat.cpu().numpy(), p_stat.numpy())
    assert torch.equal(out.cpu(), p_out)
    return p_stat.numpy()


def test_small_and_damaged_frames(cuda):
    frames, raws = own_frames(device="cuda")
    sf, sr = stock_frames()
    frames, raws = frames + sf, raws + sr
    args, n, rows = ZD.k4_inputs(frames, [len(r) for r in raws],
                                 torch.device("cpu"))
    ns = D.seq_total(rows["meta"])
    stat = _both(args, n, ns, cuda)
    assert (stat[:, 1] == 1).all()
    mid = 0
    for a in damaged_rows(args, 11, 24):
        st = _both(a, n, ns, cuda)
        bad = np.nonzero(st[:, 1] == 0)[0]
        mid += bool(len(bad)) and st[bad[0], 0] > 0
    assert mid > 0
    for i, fr in damaged_frames(frames, 13, 24):
        try:
            a, m, r2 = ZD.k4_inputs([fr], [len(raws[i])],
                                    torch.device("cpu"))
        except Exception:
            continue    # the host parse rejects it: no kernel runs
        _both(a, m, D.seq_total(r2["meta"]), cuda)


def test_level3_and_level9_frames(cuda):
    data = mixed_corpus(np.random.default_rng(11), 64 << 20).tobytes()
    raws = [data[i << 23: (i << 23) + (1 << 20)] for i in range(8)]
    for level in (3, 9):
        frames = ZstdCodec(level=level, device="cuda").compress_frames(raws)
        args, n, rows = ZD.k4_inputs(frames, [len(r) for r in raws],
                                     torch.device("cpu"))
        stat = _both(args, n, D.seq_total(rows["meta"]), cuda)
        assert (stat[:, 1] == 1).all()
