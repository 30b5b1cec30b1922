"""The plan kernel (csrc/plan.cu, ops/huffman_plan.py plan_all_cuda) on
the card against the torch plans (plan_blocks, plan_seq_tables) on the
CPU, and a zstd archive written on the card with the kernel against the
same input written with the torch plans on the card.

Rows: the chain's batch of a mixed corpus (test_torch_cuda_inputs.
mixed_batch), the crafted rows of plan_edge_rows (an empty row, a single
symbol, an RLE block, two symbols, the balanced fallback, flat codes over
more than 127 symbols, the 64-move limit, shrinking moves, n_seq below
MIN_SEQ_FSE, both accuracy logs' tables) and random rows, at the chain's
8,192 sequences a row.  Marked `cuda`: they need an NVIDIA GPU with
sm_90a and nvcc, and skip elsewhere (the check runs inside the tests).
On the GPU machine (no jax there, hence --noconftest): `python -m pytest
--noconftest -m cuda tests/test_torch_cuda*.py`.  Outputs are integer
arrays and archive bytes and must be equal (tolerance: none)."""

import hashlib
import io

import numpy as np
import pytest
import torch

from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import fse_plan as fpl
from libzseek_tpu_torch.ops import huffman_plan as hp
from libzseek_tpu_torch.runtime.writer import Writer
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import (S, cuda_device, mixed_batch,
                                    plan_edge_rows, plan_random_rows)

pytestmark = pytest.mark.cuda

KW = dict(mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
          mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ)
NAMES = ("mode", "mode_bits", "codes_packed", "weights_packed", "rle_byte",
         "sizes4", "sflags", "ctabs", "norms", "rle_syms", "gain")


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _torch_plans(t):
    """plan_blocks and plan_seq_tables, on the tensors' device."""
    return hp.plan_blocks(t["hist"], t["lit_count"], t["n_seq"],
                          t["const"], t["lens"], hist_q=t["hist_q"], **KW) \
        + fpl.plan_seq_tables(t["ll"], t["ml"], t["offv"], t["n_seq"])


def _kernel_plans(t):
    lit, seq = hp.plan_all_cuda(
        t["hist"], t["lit_count"], t["n_seq"], t["const"], t["lens"],
        hist_q=t["hist_q"], ll=t["ll"], ml=t["ml"], offv=t["offv"], **KW)
    return lit + seq


def test_plan_kernel_equals_torch_plans(cuda):
    _x2, lens, _m, seqs, *_ = mixed_batch()
    batches = [dict({k: seqs[k] for k in ("hist", "hist_q", "lit_count",
                                          "n_seq", "const", "ll", "ml",
                                          "offv")},
                    lens=torch.from_numpy(lens))]
    for b in (plan_edge_rows(S=S), plan_random_rows(
            np.random.default_rng(13), B=64, S=S)):
        batches.append({k: torch.from_numpy(v) for k, v in b.items()})
    for b in batches:
        before = hp.launches
        got = _kernel_plans({k: v.to(cuda) for k, v in b.items()})
        assert hp.launches == before + 1
        ref = _torch_plans({k: v.cpu() for k, v in b.items()})
        for name, g, r in zip(NAMES, got, ref):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.cpu().numpy(), r.numpy(),
                                          err_msg=name)


def test_archive_with_kernel_equals_torch_plans(cuda, monkeypatch):
    """24 MiB of a mixed corpus, 1 MiB frames, 16 frames a batch: three
    device batches, one plan launch each."""
    data = mixed_corpus(np.random.default_rng(17), 24 << 20).tobytes()

    def write():
        buf = io.BytesIO()
        w = Writer(buf, "zstd", level=3, device="cuda",
                   min_frame_size=1 << 20, batch_frames=16)
        for pos in range(0, len(data), 1 << 20):
            w.write(data[pos: pos + (1 << 20)])
        w.close()
        return hashlib.sha256(buf.getvalue()).hexdigest()

    plans, emits = hp.launches, E.launches
    with_kernel = write()
    n_plans, n_emits = hp.launches - plans, E.launches - emits
    assert n_plans == n_emits == 3, (n_plans, n_emits)

    def torch_on_card(hist, lit_count, n_seq, const, lens, *, ll, ml, offv,
                      **kw):
        return (hp.plan_blocks(hist, lit_count, n_seq, const, lens, **kw),
                fpl.plan_seq_tables(ll, ml, offv, n_seq))

    monkeypatch.setattr(hp, "plan_all_cuda", torch_on_card)
    plans = hp.launches
    assert write() == with_kernel
    assert hp.launches == plans
