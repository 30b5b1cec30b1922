"""Device resolution for the PyTorch port.

Counterpart of libzseek_tpu/utils/platform.py (apply_platform), which picks
the JAX backend.  The port never falls back: `device="cuda"` (the default)
needs a visible card and raises without one; `device="cpu"` runs every
kernel's plain PyTorch version and exists for the tests.  worker_devices
and RoundRobin are the codecs' `workers`: the devices their batches take
in turn.
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


def _visible_devices(device: torch.device) -> list[torch.device]:
    """The devices a codec on `device` may spread its batches over: every
    CUDA device for a CUDA `device`, else `device` alone."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def worker_devices(workers: int | None,
                   device: torch.device) -> list[torch.device] | None:
    """The codecs' `workers`, as the reference's round-robin
    (libzseek_tpu/runtime/zstd_codec.py:128-133): with workers > 1 and
    more than one visible device, the first min(workers, n) devices, which
    the batches take in turn; else None, every batch on `device`."""
    if not workers or workers <= 1:
        return None
    devs = _visible_devices(device)
    return devs[: min(workers, len(devs))] if len(devs) > 1 else None


class RoundRobin:
    """The codecs' `workers` (the reference's _put): a codec on `device`
    calls _init_workers once, then _batch_device for each batch it
    dispatches."""

    device: torch.device

    def _init_workers(self, workers: int | None) -> None:
        self._devices = worker_devices(workers, self.device)
        self._rr = 0

    def _batch_device(self) -> torch.device:
        """The next batch's device: the codec's, or the next worker's."""
        if self._devices is None:
            return self.device
        dev = self._devices[self._rr % len(self._devices)]
        self._rr += 1
        return dev
