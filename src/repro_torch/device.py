"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

DeviceLike = str | torch.device


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` becomes
    the current card, as tensors moved there report it).  Asking for
    ``cuda`` where there is no card raises: the port never carries on
    silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} asked for, but "
                f"torch.cuda.is_available() is false — pass device='cpu' "
                f"to run the plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device: torch.device) -> str:
    """Human-readable name of the device a run used."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)
