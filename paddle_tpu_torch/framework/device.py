"""Device selection for the port's entry points.

Counterpart of ``paddle_tpu/framework/device.py`` and ``place.py``. The
rule is one: an entry point runs on ``cuda`` unless its caller asks for
another device, and it never quietly drops to the CPU. Without a CUDA
device the caller must pass ``device="cpu"`` (the CPU tests do), or the
call raises.

The Paddle API (``paddle.set_device``, ``get_device``, the tensors that
``to_tensor``, the creation ops and ``Layer`` parameters make) follows the
same rule through :func:`current_place`: the place ``set_device`` chose, or
the current CUDA device; without a GPU and without ``set_device("cpu")``
creating a tensor raises. The choice is process-wide (Paddle's is; the
reference keeps it per thread). The port's model entry points keep their
``device=`` argument and do not read it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .place import (CPUPlace, CUDAPlace, NPUPlace, Place, TPUPlace, XPUPlace,
                    place_of)

__all__ = ["default_device", "resolve_device", "same_device", "set_device",
           "get_device", "current_place", "current_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_tpu", "is_compiled_with_xpu", "synchronize",
           "place_to_device"]

DeviceLike = Optional[Union[str, torch.device]]


def default_device() -> torch.device:
    """The current CUDA device, or raise when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: paddle_tpu_torch runs on the GPU "
            "unless the caller passes device='cpu' explicitly")
    return torch.device("cuda", torch.cuda.current_device())


# open LazyGuard blocks (framework/misc.py): while one is open, what would
# go to the default device goes to ``meta`` (shapes only, no memory)
_lazy_depth = 0


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → :func:`default_device` (``meta`` inside a
    ``LazyGuard``); otherwise the given device, which must exist."""
    if device is None:
        return torch.device("meta") if _lazy_depth else default_device()
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


# the place set_device chose (None: the current CUDA device)
_place: Optional[Place] = None
# places that exist as names only (using one raises)
_NAME_ONLY = {"tpu": TPUPlace, "xpu": XPUPlace, "npu": NPUPlace}


def set_device(device) -> Place:
    """``paddle.set_device``: "cpu", "gpu", "gpu:i" (or "cuda[:i]"), or a
    :class:`Place`. "tpu", "xpu" and "npu" raise: the port runs on NVIDIA
    GPUs."""
    global _place
    place = device
    if not isinstance(device, Place):
        kind, _, idx = str(device).lower().partition(":")
        if kind == "cpu":
            place = CPUPlace()
        elif kind in ("gpu", "cuda"):
            place = CUDAPlace(int(idx or 0))
        elif kind in _NAME_ONLY:
            place = _NAME_ONLY[kind](int(idx or 0))
        else:
            raise ValueError(f"Unknown device {device!r}; expected cpu or "
                             f"gpu[:i]")
    place_to_device(place)            # raises for a place the port lacks
    _place = place
    return place


def current_place() -> Place:
    """The place new tensors go to: :func:`set_device`'s choice, else the
    current CUDA device (raises without one)."""
    if _place is not None:
        return _place
    return place_of(default_device())


def place_to_device(place) -> torch.device:
    """A place, a device string ("cpu", "gpu:i", "cuda:i") or a
    ``torch.device`` → ``torch.device`` (None: :func:`current_device`)."""
    if place is None:
        return current_device()
    if isinstance(place, Place):
        return place.torch_device()
    if isinstance(place, str):
        kind = place.lower().partition(":")[0]
        if kind in _NAME_ONLY:
            return _NAME_ONLY[kind]().torch_device()
        place = place.lower().replace("gpu", "cuda")
    return resolve_device(place)


def current_device() -> torch.device:
    """The device of :func:`current_place` (``meta`` inside a
    ``LazyGuard``)."""
    if _lazy_depth:
        return torch.device("meta")
    return place_to_device(current_place())


def get_device() -> str:
    """``paddle.get_device``: "cpu" or "gpu:i"."""
    p = current_place()
    return "cpu" if isinstance(p, CPUPlace) else f"gpu:{p.get_device_id()}"


def device_count(device_type: str = "gpu") -> int:
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def synchronize(device=None) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
