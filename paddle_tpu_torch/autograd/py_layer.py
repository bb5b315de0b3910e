"""Custom autograd ops, ``paddle.autograd.PyLayer``: the port of
``paddle_tpu/autograd/py_layer.py``.

A user's layer defines static ``forward(ctx, *args)`` and
``backward(ctx, *grads)`` over Paddle tensors; ``apply`` runs them as a
``torch.autograd.Function``: ``forward`` without recording, its outputs
joined to the graph of its tensor inputs, and ``backward`` called with the
outputs' gradients, returning one gradient per tensor input in order (None
for none). ``ctx`` is a :class:`PyLayerContext` that keeps what
``save_for_backward`` was given.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "LegacyPyLayer"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.extra = {}

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


def _wrap(t):
    return None if t is None else Tensor._wrap(t)


class _Function(torch.autograd.Function):
    """The torch op behind one ``PyLayer.apply``: the tensor inputs are
    ``apply``'s arguments (so autograd links them), the rest rides in
    ``call``."""

    @staticmethod
    def forward(fctx, call, *tensors):
        cls, ctx, args, kwargs, slots = call
        args = list(args)
        for i, t in zip(slots, tensors):
            args[i] = Tensor._wrap(t)
        out = cls.forward(ctx, *args, **kwargs)
        fctx.call = call
        fctx.multi = isinstance(out, (tuple, list))
        outs = tuple(o._data if isinstance(o, Tensor) else o
                     for o in (out if fctx.multi else [out]))
        return outs if fctx.multi else outs[0]

    @staticmethod
    def backward(fctx, *grads):
        cls, ctx, _, _, slots = fctx.call
        got = cls.backward(ctx, *(_wrap(g) for g in grads))
        if not isinstance(got, (tuple, list)):
            got = (got,)
        got = [g._data if isinstance(g, Tensor) else g for g in got]
        return (None,) + tuple(got[i] if i < len(got) else None
                               for i in range(len(slots)))


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        slots = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        out = _Function.apply((cls, ctx, args, kwargs, slots),
                              *(args[i]._data for i in slots))
        if isinstance(out, tuple):
            return tuple(Tensor._wrap(o) for o in out)
        return Tensor._wrap(out)


LegacyPyLayer = PyLayer
