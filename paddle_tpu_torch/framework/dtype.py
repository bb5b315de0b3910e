"""Paddle's dtypes over torch's (the port of
``paddle_tpu/framework/dtype.py``).

Paddle names its dtypes both as objects (``paddle.float32``) and as strings
(``"float32"``). A :class:`DType` is a named handle over one ``torch.dtype``;
it compares equal to its name, its ``torch.dtype``, its numpy dtype and any
object whose ``str`` is its name (the reference's own ``DType``), so the
two packages' dtypes compare by name.

numpy has no bfloat16 of its own: ``np_dtype`` of ``bfloat16`` is
``ml_dtypes.bfloat16`` where that package is installed and None otherwise,
and ``Tensor.numpy()`` hands bfloat16 values back as float32, which holds
them exactly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DType", "convert_dtype", "to_torch_dtype", "set_default_dtype",
           "get_default_dtype", "default_float_dtype", "bool_", "uint8",
           "int8", "int16", "int32", "int64", "float16", "bfloat16",
           "float32", "float64", "complex64", "complex128"]

try:
    import ml_dtypes as _ml_dtypes
    _BF16_NP = np.dtype(_ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover - the card's machine may lack it
    _BF16_NP = None


class DType:
    """A framework dtype: named, hashable, convertible to ``torch.dtype``."""

    __slots__ = ("name", "torch_dtype", "np_dtype", "is_floating",
                 "is_integer", "is_complex", "itemsize")

    def __init__(self, name: str, torch_dtype: torch.dtype, np_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)
        self.is_floating = torch_dtype.is_floating_point
        self.is_complex = torch_dtype.is_complex
        self.is_integer = not (self.is_floating or self.is_complex) and \
            torch_dtype != torch.bool
        self.itemsize = torch.empty((), dtype=torch_dtype).element_size()

    def __repr__(self):
        return f"paddle.{self.name}"

    def __str__(self):
        return self.name

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        if isinstance(other, str):
            return self.name == _canon_name(other)
        try:
            return self.name == convert_dtype(other).name
        except (TypeError, ValueError):
            return NotImplemented


def _canon_name(name: str) -> str:
    name = name.replace("paddle.", "").replace("paddle_tpu.", "")
    return {"float": "float32", "double": "float64", "half": "float16",
            "int": "int32", "long": "int64", "bfloat": "bfloat16",
            "bool_": "bool"}.get(name, name)


bool_ = DType("bool", torch.bool, np.bool_)
uint8 = DType("uint8", torch.uint8, np.uint8)
int8 = DType("int8", torch.int8, np.int8)
int16 = DType("int16", torch.int16, np.int16)
int32 = DType("int32", torch.int32, np.int32)
int64 = DType("int64", torch.int64, np.int64)
float16 = DType("float16", torch.float16, np.float16)
bfloat16 = DType("bfloat16", torch.bfloat16, _BF16_NP)
float32 = DType("float32", torch.float32, np.float32)
float64 = DType("float64", torch.float64, np.float64)
complex64 = DType("complex64", torch.complex64, np.complex64)
complex128 = DType("complex128", torch.complex128, np.complex128)

_ALL = (bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
        float64, complex64, complex128)
_BY_NAME = {d.name: d for d in _ALL}
_BY_TORCH = {d.torch_dtype: d for d in _ALL}
_BY_NP = {d.np_dtype: d for d in _ALL if d.np_dtype is not None}


def convert_dtype(dtype) -> DType:
    """str, ``torch.dtype``, numpy dtype, :class:`DType` or the reference's
    dtype object → :class:`DType` (None stays None)."""
    if dtype is None or isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype in _BY_TORCH:
            return _BY_TORCH[dtype]
        raise ValueError(f"Unsupported dtype: {dtype!r}")
    if isinstance(dtype, str) or type(dtype).__name__ == "DType":
        name = _canon_name(str(dtype))
        if name in _BY_NAME:
            return _BY_NAME[name]
        raise ValueError(f"Unknown dtype string: {dtype!r}")
    npd = np.dtype(dtype)
    if npd in _BY_NP:
        return _BY_NP[npd]
    raise ValueError(f"Unsupported dtype: {dtype!r}")


def to_torch_dtype(dtype):
    """Any dtype-like → ``torch.dtype``; None passes through."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    return convert_dtype(dtype).torch_dtype


_default_dtype = float32


def set_default_dtype(d) -> None:
    """``paddle.set_default_dtype``: the dtype of Python floats and of
    float64 numpy data given without a dtype, and of the creation ops'
    floating results (floating dtypes only)."""
    global _default_dtype
    d = convert_dtype(d)
    if not d.is_floating:
        raise TypeError(
            f"set_default_dtype only accepts floating dtypes, got {d}")
    _default_dtype = d


def get_default_dtype() -> str:
    return _default_dtype.name


def default_float_dtype() -> DType:
    return _default_dtype
