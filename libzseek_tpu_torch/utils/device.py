"""Device resolution for the PyTorch port.

Counterpart of libzseek_tpu/utils/platform.py (apply_platform), which picks
the JAX backend.  The port never falls back: `device="cuda"` (the default)
needs a visible card and raises without one; `device="cpu"` runs every
kernel's plain PyTorch version and exists for the tests.
"""

from __future__ import annotations

import torch

from libzseek_tpu_torch.errors import ParameterError


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ParameterError(
                "device='cuda' requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ParameterError(f"unsupported device {device!r} (cuda or cpu)")
