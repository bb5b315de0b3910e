"""The functional op surface (``paddle.tensor``) and the Tensor methods: the
port of ``paddle_tpu/tensor/__init__.py``.

As the reference, every op of the surface also becomes a Tensor method at
import, and the Python operators map to ops."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op, inplace
from ..core.tensor import Tensor
from . import creation, linalg, logic, manipulation  # noqa: F401
from . import einsum as einsum_mod  # noqa: F401
from . import math, random, search, stat  # noqa: F401
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

# ---------------- the Python operators ----------------


def _bool(self) -> bool:
    return self._data.dtype == torch.bool


Tensor.__add__ = lambda self, o: math.add(self, o)
Tensor.__radd__ = lambda self, o: math.add(self, o)
Tensor.__sub__ = lambda self, o: math.subtract(self, o)
Tensor.__rsub__ = lambda self, o: apply_op("rsub", lambda a, b: b - a,
                                           self, o)
Tensor.__mul__ = lambda self, o: math.multiply(self, o)
Tensor.__rmul__ = lambda self, o: math.multiply(self, o)
Tensor.__truediv__ = lambda self, o: math.divide(self, o)
Tensor.__rtruediv__ = lambda self, o: apply_op("rdiv", lambda a, b: b / a,
                                               self, o)
Tensor.__floordiv__ = lambda self, o: math.floor_divide(self, o)
Tensor.__rfloordiv__ = lambda self, o: apply_op(
    "rfloordiv", lambda a, b: torch.floor_divide(b, a), self, o)
Tensor.__mod__ = lambda self, o: math.remainder(self, o)
Tensor.__pow__ = lambda self, o: math.pow(self, o)
Tensor.__rpow__ = lambda self, o: apply_op(
    "rpow", lambda a, b: torch.pow(b, a), self, o)
Tensor.__neg__ = lambda self: math.neg(self)
Tensor.__abs__ = lambda self: math.abs(self)
Tensor.__matmul__ = lambda self, o: linalg.matmul(self, o)
Tensor.__rmatmul__ = lambda self, o: apply_op(
    "rmatmul", lambda a, b: torch.matmul(b, a), self, o)
Tensor.__eq__ = lambda self, o: logic.equal(self, o)
Tensor.__ne__ = lambda self, o: logic.not_equal(self, o)
Tensor.__lt__ = lambda self, o: logic.less_than(self, o)
Tensor.__le__ = lambda self, o: logic.less_equal(self, o)
Tensor.__gt__ = lambda self, o: logic.greater_than(self, o)
Tensor.__ge__ = lambda self, o: logic.greater_equal(self, o)
Tensor.__invert__ = lambda self: logic.logical_not(self) if _bool(self) \
    else logic.bitwise_not(self)
Tensor.__and__ = lambda self, o: logic.logical_and(self, o) if _bool(self) \
    else logic.bitwise_and(self, o)
Tensor.__or__ = lambda self, o: logic.logical_or(self, o) if _bool(self) \
    else logic.bitwise_or(self, o)
Tensor.__xor__ = lambda self, o: logic.logical_xor(self, o) if _bool(self) \
    else logic.bitwise_xor(self, o)
Tensor.__hash__ = object.__hash__

Tensor.__iadd__ = lambda self, o: math.add_(self, o)
Tensor.__isub__ = lambda self, o: math.subtract_(self, o)
Tensor.__imul__ = lambda self, o: math.multiply_(self, o)
Tensor.__itruediv__ = lambda self, o: math.divide_(self, o)


def _index(i):
    if isinstance(i, Tensor):
        i = i._data
    elif isinstance(i, (list, np.ndarray)):
        i = torch.as_tensor(np.asarray(i))
    if isinstance(i, torch.Tensor) and i.dtype not in (torch.bool,
                                                       torch.long):
        i = i.long()
    return i


def _key(idx):
    return tuple(_index(i) for i in idx) if isinstance(idx, tuple) \
        else _index(idx)


def _getitem(self, idx):
    key = _key(idx)

    def fn(a):
        k = key
        if isinstance(k, torch.Tensor) and k.device != a.device:
            k = k.to(a.device)
        elif isinstance(k, tuple):
            k = tuple(i.to(a.device) if isinstance(i, torch.Tensor) else i
                      for i in k)
        return a[k]
    return apply_op("getitem", fn, self)


def _setitem(self, idx, value):
    key = _key(idx)

    def fn(a, v):
        out = a.clone()
        out[key] = torch.as_tensor(v, dtype=a.dtype, device=a.device) \
            if not isinstance(v, torch.Tensor) else v.to(a.dtype)
        return out
    inplace(self, apply_op("setitem", fn, self, value))


Tensor.__getitem__ = _getitem
Tensor.__setitem__ = _setitem

# ---------------- the methods ----------------

_METHOD_SOURCES = [creation, linalg, logic, manipulation, math, random,
                   search, stat, einsum_mod]
_SKIP = {"to_tensor", "create_parameter", "create_tensor", "arange",
         "linspace", "logspace", "eye", "zeros", "ones", "full", "empty",
         "meshgrid", "tril_indices", "triu_indices", "rand", "randn",
         "randint", "randperm", "uniform", "normal", "standard_normal",
         "gaussian", "assign"}


def _patch_methods():
    for mod in _METHOD_SOURCES:
        for fname in dir(mod):
            if fname.startswith("_") or fname in _SKIP:
                continue
            fn = getattr(mod, fname)
            if not callable(fn) or isinstance(fn, type):
                continue
            if getattr(fn, "__module__", "").startswith(
                    "paddle_tpu_torch.tensor") and not hasattr(Tensor,
                                                               fname):
                setattr(Tensor, fname, fn)


_patch_methods()

# the surface `from paddle_tpu_torch.tensor import *` (and the top level)
# exports: the ops, not the modules' imports
__all__ = sorted({n for mod in _METHOD_SOURCES for n, obj in vars(mod).items()
                  if not n.startswith("_") and str(getattr(
                      obj, "__module__", "")).startswith(
                          "paddle_tpu_torch.tensor")}
                 | {"Tensor", "to_tensor"})

Tensor.astype = lambda self, dtype: manipulation.cast(self, dtype)
Tensor.cast = lambda self, dtype: manipulation.cast(self, dtype)
Tensor.mm = linalg.mm
Tensor.matmul = linalg.matmul
Tensor.dot = linalg.dot
Tensor.norm = linalg.norm
Tensor.dim = lambda self: self.ndim
Tensor.ndimension = lambda self: self.ndim
Tensor.element_size = lambda self: self.dtype.itemsize


def _sigmoid_method(self, name=None):
    from ..nn.functional import sigmoid
    return sigmoid(self)


def _sigmoid_method_(self, name=None):
    from ..nn.functional import sigmoid
    return inplace(self, sigmoid(self))


Tensor.sigmoid = _sigmoid_method
Tensor.sigmoid_ = _sigmoid_method_
Tensor.create_parameter = staticmethod(creation.create_parameter)
Tensor.create_tensor = staticmethod(creation.create_tensor)
Tensor.is_floating_point = lambda self: self.dtype.is_floating
Tensor.is_integer = lambda self: self.dtype.is_integer
Tensor.is_complex = lambda self: self.dtype.is_complex
