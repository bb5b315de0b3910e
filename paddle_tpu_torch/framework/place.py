"""Places: the port of ``paddle_tpu/framework/place.py``.

A :class:`Place` names where a tensor lives and maps onto a
``torch.device``. The port runs on NVIDIA GPUs: ``CUDAPlace(i)`` is
``cuda:i``, ``CPUPlace`` and ``CUDAPinnedPlace`` the host. ``TPUPlace``,
``XPUPlace`` and ``NPUPlace`` exist as names, so scripts that mention them
import; placing a tensor on one raises, naming the devices the port has.
"""
from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "NPUPlace", "place_of"]


class Place:
    """Base place: a device type and an index."""

    device_type = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self._device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.device_type, self._device_id))

    def is_cpu_place(self) -> bool:
        return self.device_type == "cpu"

    def is_gpu_place(self) -> bool:
        return self.device_type == "gpu"

    def torch_device(self) -> torch.device:
        raise RuntimeError(
            f"{self!r}: paddle_tpu_torch runs on NVIDIA GPUs (CUDA) and the "
            f"host CPU only; use CUDAPlace or CPUPlace")


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "Place(cpu)"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{self!r} requested but no CUDA device is "
                               f"available")
        return torch.device("cuda", self._device_id)


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory (tensors placed here are pinned)."""

    device_type = "gpu_pinned"

    def __repr__(self):
        return "Place(gpu_pinned)"


class TPUPlace(Place):
    device_type = "tpu"


class XPUPlace(Place):
    device_type = "xpu"


class NPUPlace(Place):
    device_type = "npu"


def place_of(device: torch.device) -> Place:
    """The :class:`Place` of a ``torch.device``."""
    if device.type == "cuda":
        return CUDAPlace(device.index if device.index is not None
                         else torch.cuda.current_device())
    return CPUPlace()
