"""Comparison and logical ops: the port of ``paddle_tpu/tensor/logic.py``."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op, unwrap
from ..core.tensor import Tensor
from .math import _reduce


def _as(b, a):
    return b if isinstance(b, torch.Tensor) else torch.as_tensor(
        b, device=a.device)


def _cmp(op_name, fn):
    def op(x, y, name=None):  # noqa: A002 - `name` is Paddle's user label
        return apply_op(op_name, lambda a, b: fn(a, _as(b, a)), x, y)
    op.__name__ = op_name
    return op


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, out=None, name=None):
    return apply_op("logical_not", torch.logical_not, x)


def bitwise_not(x, out=None, name=None):
    return apply_op("bitwise_not", torch.bitwise_not, x)


def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return apply_op("bitwise_left_shift", torch.bitwise_left_shift, x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    return apply_op("bitwise_right_shift", torch.bitwise_right_shift, x, y)


def equal_all(x, y, name=None):
    return apply_op("equal_all", lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(a, b)), device=a.device),
        x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op("allclose", lambda a, b: torch.tensor(torch.allclose(
        a, b, rtol=float(unwrap(rtol)), atol=float(unwrap(atol)),
        equal_nan=equal_nan), device=a.device), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_op("isclose", lambda a, b: torch.isclose(
        a, b, rtol=float(unwrap(rtol)), atol=float(unwrap(atol)),
        equal_nan=equal_nan), x, y)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op("all", lambda a: _reduce(torch.all, a.bool(), axis,
                                             keepdim), x)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op("any", lambda a: _reduce(torch.any, a.bool(), axis,
                                             keepdim), x)


def is_empty(x, name=None):
    return apply_op("is_empty", lambda a: torch.tensor(
        a.numel() == 0, device=a.device), x)


def is_tensor(x):
    return isinstance(x, Tensor)


def is_complex(x):
    return unwrap(x).is_complex()


def is_integer(x):
    t = unwrap(x)
    return not (t.is_floating_point() or t.is_complex()) and \
        t.dtype != torch.bool


def is_floating_point(x):
    return unwrap(x).is_floating_point()
