"""Device resolution for the PyTorch port.

Counterpart of libzseek_tpu/utils/platform.py (apply_platform), which picks
the JAX backend.  The port never falls back: `device="cuda"` (the default)
needs a visible card and raises without one; `device="cpu"` runs every
kernel's plain PyTorch version and exists for the tests.  check_workers
holds the codecs' `workers` to what one device can do.
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


def check_workers(workers: int | None, device: torch.device) -> None:
    """The codecs' `workers` (the reference's round-robin of batches over
    its first `workers` devices, libzseek_tpu/runtime/zstd_codec.py:
    121-133).  With one visible device the reference uses that device,
    and so does the port; spreading the batches over more than one CUDA
    device is not ported yet (ROADMAP A3) and raises."""
    if not workers or workers <= 1 or device.type != "cuda":
        return
    n = torch.cuda.device_count()
    if n > 1:
        raise ParameterError(
            f"workers={workers} would spread batches over {min(workers, n)} "
            f"of {n} CUDA devices: the round-robin is not ported "
            f"(ROADMAP A3)")
