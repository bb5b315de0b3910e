"""Eager op dispatch of the Paddle API (the port of
``paddle_tpu/core/dispatch.py``).

An op of the Paddle surface is a torch function over plain tensors;
:func:`apply_op` is the boundary it runs behind:

1. the arguments are unwrapped (a :class:`Tensor` gives its ``_data``);
2. under ``amp.auto_cast`` the floating tensors are cast by the op's
   reference name (``amp/auto_cast.py::cast_dtype``: the white and black
   lists, O1 and O2), as the reference casts at its boundary
   (``paddle_tpu/core/dispatch.py:63-67``), and the op's body runs with the
   rule suspended, so a torch function inside it that the port's
   ``TorchFunctionMode`` also names is not cast a second time;
3. the op runs; torch's autograd records it (no tape of the port's);
4. with ``FLAGS_check_nan_inf`` set, a floating output holding NaN or Inf
   raises ``FloatingPointError`` with the reference's message (this reads
   the card back, so it syncs only when the flag is set);
5. the outputs are wrapped as :func:`unwrap_tree` decides.

The same unwrap/wrap rule serves ``Tensor.__torch_function__``: the type of
the data decides the type out. A result is a Paddle tensor when a Paddle
tensor that is not layer state (a parameter or a buffer) is among the
arguments, or when no torch tensor is; a torch tensor in gives a torch
tensor out, even through a Paddle layer's parameters.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..amp.auto_cast import _cast, _state as _amp_state, cast_dtype
from ..framework.flags import _REGISTRY as _FLAGS
from .tensor import Tensor

__all__ = ["apply_op", "unwrap", "unwrap_tree", "wrap_tree", "inplace"]

_NAN_INF = _FLAGS["FLAGS_check_nan_inf"]


def unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def wrap_tree(out):
    """Wrap every ``torch.Tensor`` in a result (tuples and lists kept)."""
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    if isinstance(out, tuple):
        return tuple(wrap_tree(o) for o in out)
    if isinstance(out, list):
        return [wrap_tree(o) for o in out]
    return out


def unwrap_tree(obj):
    """``(obj with every Tensor unwrapped, whether the result should be
    Paddle)``; lists, tuples and dicts are walked. The result is Paddle
    when a Paddle tensor that is not layer state is among them, or when
    Paddle state is and no torch tensor is."""
    seen = [False, False, False]        # data Tensor, state Tensor, torch

    def un(x):
        if isinstance(x, Tensor):
            seen[1 if x._state else 0] = True
            return x._data
        if isinstance(x, torch.Tensor):
            seen[2] = True
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(un(v) for v in x) if type(x) in (list, tuple) \
                else x
        if isinstance(x, dict):
            return {k: un(v) for k, v in x.items()}
        return x
    out = un(obj)
    return out, seen[0] or (seen[1] and not seen[2])


def _check_nan_inf(name, outs):
    for o in outs:
        if isinstance(o, torch.Tensor) and (o.is_floating_point()
                                            or o.is_complex()):
            if not bool(torch.isfinite(o.detach()).all()):
                raise FloatingPointError(
                    f"Operator {name} output contains NaN or Inf "
                    f"(FLAGS_check_nan_inf is set).")


def apply_op(name: str, fn: Callable, *args, **kwargs) -> Any:
    """Run ``fn`` over the unwrapped ``args`` (keyword arguments are
    constants) behind the Paddle boundary (see the module docstring)."""
    data = []
    paddle_in = torch_in = False
    for a in args:
        if isinstance(a, Tensor):
            if not a._state:
                paddle_in = True
            data.append(a._data)
        else:
            if isinstance(a, torch.Tensor):
                torch_in = True
            data.append(a)
    amp = getattr(_amp_state, "amp", None)
    if amp is not None:
        dtype = cast_dtype(name)
        if dtype is not None:
            data = [_cast(a, dtype) for a in data]
        _amp_state.amp = None
        try:
            out = fn(*data, **kwargs)
        finally:
            _amp_state.amp = amp
    else:
        out = fn(*data, **kwargs)
    if _NAN_INF.value:
        _check_nan_inf(name, out if isinstance(out, (tuple, list))
                       else (out,))
    if paddle_in or not torch_in:
        return wrap_tree(out)
    return out


def inplace(x: Tensor, r) -> Tensor:
    """Make ``x`` hold the op result ``r`` (a Paddle ``op_``).

    Where autograd is involved (grad mode on and either side requiring a
    gradient) ``x`` is rebound to the result, keeping the graph, as the
    reference's ``_inplace``; a leaf that required a gradient keeps
    receiving it (``Tensor._leaf``). Layer state (parameters, buffers) and
    tensors outside any graph are written in place instead, so the objects
    that alias them (a layer, an optimizer, ``.grad``) see the new value."""
    rd = r._data if isinstance(r, Tensor) else r
    xd = x._data
    graph = torch.is_grad_enabled() and (xd.requires_grad or
                                         rd.requires_grad)
    if (x._state or not graph) and rd.shape == xd.shape and \
            rd.dtype == xd.dtype:
        with torch.no_grad():
            xd.copy_(rd)
        return x
    if xd.requires_grad and xd.is_leaf and x._leaf is None:
        x._leaf = xd
    x._data = rd
    return x
