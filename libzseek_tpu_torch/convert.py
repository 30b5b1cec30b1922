"""Carry the JAX package's arrays across to the port's tensors.

The port keeps the JAX package's array contracts (shapes, layouts, field
names) but stores every 32-bit word buffer as int32 (torch has no full
uint32 arithmetic): a uint32 array from libzseek_tpu arrives here as the
int32 view of the same bits, bool stays bool, uint8 stays uint8 and every
other integer array becomes int32.  Tests hand each port stage exactly the
reference's inputs this way (for example the `seqs` dict of
libzseek_tpu/ops/zstd_encode.zstd_sequences_linked, or the outputs of
libzseek_tpu/ops/huffman_plan.plan_blocks) and compare outputs with
`to_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device: str | torch.device = "cuda") -> torch.Tensor:
    """numpy (or array-like) -> tensor with the port's dtype."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.bool_ or a.dtype == np.uint8:
        pass
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        raise TypeError(f"no port dtype for {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """tensor -> numpy; `dtype=np.uint32` reinterprets int32 words."""
    a = t.detach().cpu().numpy()
    if dtype is not None and np.dtype(dtype) == np.uint32:
        return a.view(np.uint32)
    return a if dtype is None else a.astype(dtype)


def seqs_to_torch(seqs: dict, device: str | torch.device = "cuda") -> dict:
    """A sequences dict (ll, ml, offv, n_seq, hist, hist_q, lit_count,
    const, lit_mask, ...) from the JAX package -> port tensors."""
    return {k: to_torch(np.asarray(v), device) for k, v in seqs.items()}
