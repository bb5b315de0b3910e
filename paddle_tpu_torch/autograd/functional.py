"""Functional autodiff transforms over functions of Paddle tensors
(``vjp``, ``jvp``, ``jacobian``, ``hessian``): the port of
``paddle_tpu/autograd/functional.py``, over
``torch.autograd.functional``. Results are Paddle tensors without a graph,
in the reference's structure: ``jacobian``/``hessian`` of several inputs
(and outputs) nest by output, then input; a single input not in a list
gives the matrix itself."""
from __future__ import annotations

import torch
import torch.autograd.functional as taf

from ..core.tensor import Tensor

__all__ = ["vjp", "jvp", "jacobian", "hessian", "backward"]


def _data(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _on_torch(func):
    def f(*ts):
        out = func(*(Tensor._wrap(t) for t in ts))
        if isinstance(out, (tuple, list)):
            return tuple(_data(o) for o in out)
        return _data(out)
    return f


def _wrap_tree(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_wrap_tree(t) for t in tree)
    return Tensor._wrap(tree.detach())


def _inputs(xs):
    return tuple(_data(x) for x in (xs if isinstance(xs, (list, tuple))
                                    else [xs]))


def vjp(func, xs, v=None):
    """``(func(xs), vᵀ J)``; ``v`` defaults to ones of the output's
    shape."""
    ins = _inputs(xs)
    f = _on_torch(func)
    if v is None:
        with torch.no_grad():
            out = f(*ins)
        v = tuple(torch.ones_like(o) for o in out) if isinstance(
            out, tuple) else torch.ones_like(out)
    else:
        v = tuple(_data(t) for t in v) if isinstance(v, (list, tuple)) \
            else _data(v)
    out, grads = taf.vjp(f, ins, v)
    return _wrap_tree(out), list(_wrap_tree(grads))


def jvp(func, xs, v=None):
    """``(func(xs), J v)``; ``v`` defaults to ones of the inputs'
    shapes."""
    ins = _inputs(xs)
    v = tuple(torch.ones_like(t) for t in ins) if v is None else \
        _inputs(v)
    out, jv = taf.jvp(_on_torch(func), ins, v)
    return _wrap_tree(out), _wrap_tree(jv)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    jac = taf.jacobian(_on_torch(func), _inputs(xs))
    jac = _wrap_tree(jac)
    if not isinstance(xs, (list, tuple)):
        return jac[0] if isinstance(jac, tuple) else jac
    return jac


def hessian(func, xs, create_graph=False, allow_unused=False):
    hes = _wrap_tree(taf.hessian(_on_torch(func), _inputs(xs)))
    if not isinstance(xs, (list, tuple)):
        while isinstance(hes, tuple):
            hes = hes[0]
    return hes


def backward(tensors, grad_tensors=None, retain_graph=False):
    from ..core.autograd import backward as _backward
    return _backward(tensors, grad_tensors, retain_graph)
