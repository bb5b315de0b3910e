"""Tensor creation: the port of ``paddle_tpu/tensor/creation.py``. New
tensors go to :func:`framework.device.current_place`."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op, unwrap
from ..core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ..framework.device import current_device


def _dt(dtype, default_float=True):
    if dtype is None:
        return dtype_mod.default_float_dtype().torch_dtype \
            if default_float else None
    return dtype_mod.to_torch_dtype(dtype)


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.numpy().tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(unwrap(s)) for s in shape]


def _new(fn, *args, **kwargs) -> Tensor:
    return Tensor._wrap(fn(*args, device=current_device(), **kwargs))


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, _shape_list(shape), dtype=_dt(dtype))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, _shape_list(shape), dtype=_dt(dtype))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = unwrap(fill_value)
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None and isinstance(fill_value, (bool, int, np.integer)):
        dtype = "bool" if isinstance(fill_value, bool) else "int64"
    return _new(torch.full, _shape_list(shape), fill_value, dtype=_dt(dtype))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype, name)


def zeros_like(x, dtype=None, name=None):
    return apply_op("zeros_like", lambda a: torch.zeros_like(
        a, dtype=_dt(dtype, False)), x)


def ones_like(x, dtype=None, name=None):
    return apply_op("ones_like", lambda a: torch.ones_like(
        a, dtype=_dt(dtype, False)), x)


def full_like(x, fill_value, dtype=None, name=None):
    v = unwrap(fill_value)
    v = v.item() if isinstance(v, torch.Tensor) else v
    return apply_op("full_like", lambda a: torch.full_like(
        a, v, dtype=_dt(dtype, False)), x)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


def _scalar(v):
    v = unwrap(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = "int64" if all(isinstance(v, (int, np.integer))
                               for v in (start, end, step)) \
            else dtype_mod.get_default_dtype()
    return _new(torch.arange, start, end, step, dtype=_dt(dtype))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace, _scalar(start), _scalar(stop),
                int(_scalar(num)), dtype=_dt(dtype))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace, _scalar(start), _scalar(stop),
                int(_scalar(num)), base=base, dtype=_dt(dtype))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return _new(torch.eye, num_rows,
                num_rows if num_columns is None else num_columns,
                dtype=_dt(dtype))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        if a.dim() == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones_like(a, dtype=torch.bool),
                                  offset)
                out = torch.where(mask, out, torch.full_like(
                    out, padding_value))
            return out
        return torch.diagonal(a, offset).clone()
    return apply_op("diag", fn, x)


def diagflat(x, offset=0, name=None):
    return apply_op("diagflat", lambda a: torch.diagflat(a, offset), x)


def tril(x, diagonal=0, name=None):
    return apply_op("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply_op("triu", lambda a: torch.triu(a, diagonal), x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply_op("meshgrid", lambda *xs: tuple(
        torch.meshgrid(*xs, indexing="ij")), *args))


def assign(x, output=None):
    result = apply_op("assign", torch.clone, x) if isinstance(x, Tensor) \
        else to_tensor(np.asarray(x))
    if output is not None:
        output.set_value(result)
        return output
    return result


def clone(x, name=None):
    return x.clone()


def tril_indices(row, col, offset=0, dtype="int64"):
    r, c = np.tril_indices(row, offset, col)
    return _new(torch.as_tensor, np.stack([r, c]), dtype=_dt(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    r, c = np.triu_indices(row, offset, col)
    return _new(torch.as_tensor, np.stack([r, c]), dtype=_dt(dtype))


def complex(real, imag, name=None):
    return apply_op("complex", torch.complex, real, imag)


def create_tensor(dtype, name=None, persistable=False):
    """An empty tensor of ``dtype`` for the caller to assign into."""
    t = _new(torch.zeros, (0,), dtype=_dt(dtype))
    t.name = name
    t.persistable = persistable
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A :class:`Parameter`: zeros for a bias, N(0, 0.02²) otherwise, or
    ``default_initializer(shape, dtype)``."""
    shape = _shape_list(shape)
    tdt = _dt(dtype)
    dev = current_device()
    if default_initializer is not None:
        data = unwrap(default_initializer(shape, tdt))
    elif is_bias:
        data = torch.zeros(shape, dtype=tdt, device=dev)
    else:
        gen = random_mod.default_generator().for_device(dev)
        data = torch.randn(shape, generator=gen, dtype=tdt, device=dev) * 0.02
    return Parameter(data, name=name)
