"""The redesigned K2 (csrc/entropy.cu) and K3 (csrc/place_literals.cu)
against their plain versions on the card.

K2 on the batches that give it every literal: the hash write's K2 arm
(literal-heavy 128 KiB text rows with the modes and codes the arm
passes) and the level-9 write (64 KiB rows, per-block tables), each
captured from the port's codec on 1 MiB of text, and on crafted rows
(tests/test_torch_cuda_inputs.k2_edge_rows, at 16 and 64 KiB); K3 on
the level-3 write's text rows (captured the same way) and on crafted
coverage masks (k3_edge_rows).  Marked `cuda`: they need an NVIDIA GPU
with sm_90a and nvcc, and skip elsewhere (the check runs inside the
tests).  On the GPU machine (no jax there, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are integer words and must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import vector_entropy as VE
from libzseek_tpu_torch.testing.capture import first_call
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import cuda_device, k2_edge_rows, k3_edge_rows
from test_torch_cuda_inputs import same as _same

pytestmark = pytest.mark.cuda

MIB = 1 << 20


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


@pytest.fixture(scope="module")
def text():
    """The first MiB of a mixed corpus: its text-like quarter."""
    return [mixed_corpus(np.random.default_rng(11), 4 * MIB)[:MIB]
            .tobytes()]


def _on(dev, v):
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def _k2_both(cuda, args, kw):
    card = E.entropy_emit(*(_on(cuda, a) for a in args),
                          **{k: _on(cuda, v) for k, v in kw.items()})
    plain = E.entropy_emit(*(_on("cpu", a) for a in args),
                           **{k: _on("cpu", v) for k, v in kw.items()})
    _same(card, plain)


def test_k2_kernel_literal_rows(cuda, text):
    for codec in (ZstdCodec(device="cuda", parser="hash"),
                  ZstdCodec(level=9, device="cuda")):
        call = first_call(E, "entropy_emit", codec, text)
        args, kw = call.args, call.kwargs
        meta = args[4].cpu()
        assert int(meta[:, 1].sum()) > 0 and \
            bool(((meta[:, 3] & E.MODE_HUF) != 0).any())
        _k2_both(cuda, args, kw)
    for N in (16384, 65536):
        x, ll, ml, off, meta, codes, S = k2_edge_rows(N)
        _k2_both(cuda, (x, ll, ml, off, meta, codes, S,
                        (N + 64 + 127) // 128 * 128,
                        (9 * S + 64 + 127) // 128 * 128), {})


def test_k3_kernel_text_and_crafted_rows(cuda, text):
    args = first_call(VE, "vector_literals", ZstdCodec(device="cuda"),
                      text).args
    assert bool(args[4].any())
    lit_cap = (VE.N_BLOCK + 64 + 127) // 128 * 128
    for a in (args[:5], k3_edge_rows()):
        card = VE.vector_literals(*(_on(cuda, v) for v in a), lit_cap)
        plain = VE.vector_literals(*(_on("cpu", v) for v in a), lit_cap)
        _same(card, plain)
