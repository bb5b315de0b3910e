"""``paddle.incubate.autograd``: the port of
``paddle_tpu/incubate/autograd/__init__.py``: the functional transforms,
the lazy ``Jacobian``/``Hessian`` objects, ``grad``, the eager
``forward_grad`` and the prim switches.

The reference's ``orig2prim``, ``prim2orig`` and ``to_prim`` rewrite a
static Program into primitive ops, and its ``forward_grad`` has a branch
for static Programs; the port has no static Program yet (ROADMAP queue 1,
item 5d), so those raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ...autograd.functional import hessian, jacobian, jvp, vjp  # noqa: F401
from ...core.tensor import Tensor

__all__ = ["Jacobian", "Hessian", "forward_grad", "grad", "jacobian",
           "hessian", "jvp", "vjp", "enable_prim", "disable_prim",
           "prim_enabled", "orig2prim", "prim2orig", "to_prim"]

_NO_PROGRAM = ("{} rewrites a static Program, which the port does not have "
               "yet (ROADMAP queue 1, item 5d)")


class Jacobian:
    """A lazy Jacobian: ``J[i, j]`` is d out_i / d in_j, the whole matrix
    computed by :func:`jacobian` at the first access."""

    def __init__(self, func, xs, is_batched=False):
        if is_batched:
            raise NotImplementedError(
                "batched Jacobian/Hessian objects: vmap the functional "
                "jacobian/hessian instead")
        self._func = func
        self._xs = xs
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            self._mat = jacobian(self._func, self._xs)
        return self._mat

    def __getitem__(self, idx):
        return self._materialize()[idx]

    @property
    def shape(self):
        return self._materialize().shape


class Hessian(Jacobian):
    """A lazy Hessian, as :class:`Jacobian`, by :func:`hessian`."""

    def _materialize(self):
        if self._mat is None:
            self._mat = hessian(self._func, self._xs)
        return self._mat


_state = {"enabled": False}


def enable_prim():
    _state["enabled"] = True


def disable_prim():
    _state["enabled"] = False


def prim_enabled() -> bool:
    return _state["enabled"]


def _not_ported(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(_NO_PROGRAM.format(name))
    stub.__name__ = name
    stub.__not_ported__ = True
    return stub


orig2prim = _not_ported("orig2prim")
prim2orig = _not_ported("prim2orig")
to_prim = _not_ported("to_prim")


def _list(x):
    return [x] if isinstance(x, Tensor) else list(x)


def forward_grad(outputs, inputs, grad_inputs=None):
    """The tangents of ``outputs`` along ``grad_inputs`` (ones by default)
    at ``inputs``, J v, from the graph already recorded for ``outputs``
    (which must not have been freed by a ``backward`` without
    ``retain_graph``): the vector-Jacobian product with a placeholder
    cotangent u, then its derivative in u along v. The graph stays for a
    later backward. Tensors without a graph to ``inputs`` get zeros."""
    single = isinstance(outputs, Tensor)
    outs = [o._data for o in _list(outputs)]
    ins = [t._data for t in _list(inputs)]
    seeds = [torch.ones_like(t) for t in ins] if grad_inputs is None else \
        [g._data if isinstance(g, Tensor) else torch.as_tensor(g)
         for g in _list(grad_inputs)]
    results = []
    for o in outs:
        if not o.requires_grad:
            results.append(torch.zeros_like(o))
            continue
        u = torch.zeros_like(o, requires_grad=True)
        with torch.enable_grad():
            g = torch.autograd.grad(o, ins, u, retain_graph=True,
                                    create_graph=True, allow_unused=True)
        pairs = [(gi, s) for gi, s in zip(g, seeds)
                 if gi is not None and gi.requires_grad]
        if not pairs:
            results.append(torch.zeros_like(o))
            continue
        jv = torch.autograd.grad([gi for gi, _ in pairs], u,
                                 [s for _, s in pairs], allow_unused=True)[0]
        results.append(torch.zeros_like(o) if jv is None else jv)
    results = [Tensor._wrap(r.detach()) for r in results]
    return results[0] if single else results


def grad(outputs, inputs, grad_outputs=None):
    from ...core.autograd import grad as _grad
    return _grad(outputs, inputs, grad_outputs)
