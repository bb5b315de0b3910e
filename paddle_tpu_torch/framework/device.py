"""Device selection for the port's entry points.

Counterpart of ``paddle_tpu/framework/device.py`` and ``place.py``. The
rule is one: an entry point runs on ``cuda`` unless its caller asks for
another device, and it never quietly drops to the CPU. Without a CUDA
device the caller must pass ``device="cpu"`` (the CPU tests do), or the
call raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device", "same_device"]

DeviceLike = Optional[Union[str, torch.device]]


def default_device() -> torch.device:
    """The current CUDA device, or raise when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: paddle_tpu_torch runs on the GPU "
            "unless the caller passes device='cpu' explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → :func:`default_device`; otherwise the given device,
    which must exist."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               f"device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)
