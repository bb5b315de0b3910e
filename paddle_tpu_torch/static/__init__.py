"""``paddle.static`` of the port: only ``InputSpec`` (the port of
``paddle_tpu/static/__init__.py:28``), which ``jit.save`` reads. Program,
Executor and the reference's ``.pdmodel`` import and export wait for ROADMAP
queue 1 item 5d."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["InputSpec", "to_torch_dtype"]

_TORCH_DTYPES = {"bool": torch.bool, "uint8": torch.uint8,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32, "float64": torch.float64}


def to_torch_dtype(dtype) -> torch.dtype:
    """A dtype named as the reference names them ("float32", "int64"), a
    numpy dtype or a torch dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name.removeprefix("paddle.")]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


class InputSpec:
    """``paddle.static.InputSpec``: a feed's shape (``None`` or -1 for a
    dimension of any extent), dtype and name."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
