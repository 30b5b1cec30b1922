"""The port never hands a tensor that is not on the CPU to a plain
version."""

import pytest
import torch


class _Launch(Exception):
    pass


def test_non_cpu_tensors_go_to_the_kernels(monkeypatch):
    """A tensor that is not on the CPU reaches a kernel launch (here a
    stub that raises), never a plain version."""
    from libzseek_tpu_torch import kernels
    from libzseek_tpu_torch.ops import entropy as E
    from libzseek_tpu_torch.ops import vector_entropy as VE
    from libzseek_tpu_torch.ops.parse_linked import parse_linked

    def launch():
        raise _Launch

    monkeypatch.setattr(kernels, "library", launch)
    meta = torch.device("meta")
    N, B, S = 4096, 2, 8192
    i32 = dict(dtype=torch.int32)
    with pytest.raises(_Launch):
        parse_linked(torch.empty((B + 1, N), dtype=torch.uint8, device=meta),
                     torch.full((B,), N, **i32), torch.tensor([N, 2 * N],
                                                               **i32),
                     torch.full((B,), 64, **i32))
    seq = torch.empty((B, S), device=meta, **i32)
    with pytest.raises(_Launch):
        E.entropy_emit(torch.empty((B, N), dtype=torch.uint8, device=meta),
                       seq, seq, seq, torch.empty((B, 8), device=meta, **i32),
                       torch.empty((B, 256), device=meta, **i32), S,
                       N + 128, 9 * S + 128)
    with pytest.raises(_Launch):
        NV = VE.N_BLOCK
        VE.vector_literals(torch.empty((B, NV), dtype=torch.uint8,
                                       device=meta),
                           torch.empty((B, NV // 32), device=meta, **i32),
                           torch.empty((B, 256), device=meta, **i32),
                           torch.full((B,), NV, device=meta, **i32),
                           torch.ones((B,), dtype=torch.bool, device=meta),
                           NV + 128)
