"""Autograd of the Paddle API over ``torch.autograd``: the counterpart of
``paddle_tpu/core/autograd.py``.

The reference keeps its own tape (grad nodes holding ``jax.vjp``
pullbacks, walked in topological order). Here torch records every op, so
this module only maps Paddle's surface onto torch's: ``backward``, ``grad``
(second order through ``create_graph``), ``no_grad`` (a context manager and
a decorator, with or without the call), ``enable_grad``,
``set_grad_enabled`` and ``saved_tensors_hooks``.

Two reference behaviours are kept: ``backward`` from a tensor that needs no
gradient does nothing (torch raises), and ``grad`` of an input the outputs
do not use raises the reference's message unless ``allow_unused``.
"""
from __future__ import annotations

import functools

import torch

from .tensor import Tensor

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "saved_tensors_hooks", "no_grad_decorator"]


def _data(x):
    return x._data if isinstance(x, Tensor) else x


def _list(xs):
    return [xs] if isinstance(xs, (Tensor, torch.Tensor)) else list(xs)


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """``paddle.autograd.backward``: accumulate the gradients of
    ``tensors`` into the ``.grad`` of every leaf with
    ``stop_gradient=False``."""
    tensors = _list(tensors)
    grads = [None] * len(tensors) if grad_tensors is None else \
        [_data(g) for g in _list(grad_tensors)]
    pairs = [(_data(t), g) for t, g in zip(tensors, grads)
             if _data(t).requires_grad]
    if not pairs:
        return
    outs, gs = zip(*pairs)
    for o, g in pairs:
        if g is None and o.numel() != 1:
            raise RuntimeError(
                "grad can be implicitly created only for scalar outputs; "
                f"got shape {list(o.shape)}")
    torch.autograd.backward(
        list(outs), None if all(g is None for g in gs) else
        [g if g is not None else torch.ones_like(o) for o, g in pairs],
        retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, leaving every ``.grad`` untouched; with ``create_graph`` the
    results carry a graph and can be differentiated again. ``retain_graph``
    defaults to ``create_graph``."""
    outputs, inputs = _list(outputs), _list(inputs)
    if retain_graph is None:
        retain_graph = create_graph
    gouts = None
    if grad_outputs is not None:
        gouts = [None if g is None else _data(g)
                 for g in _list(grad_outputs)]
    used = [i for i, t in enumerate(inputs) if _data(t).requires_grad]
    outs = [_data(o) for o in outputs]
    keep = [j for j, o in enumerate(outs) if o.requires_grad]
    results = [None] * len(inputs)
    if used and keep:
        got = torch.autograd.grad(
            [outs[j] for j in keep], [_data(inputs[i]) for i in used],
            None if gouts is None else [gouts[j] for j in keep],
            retain_graph=bool(retain_graph), create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(used, got):
            results[i] = g
    if not allow_unused and any(r is None for r in results):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph. Set allow_unused=True if this is desired.")
    return [None if g is None else Tensor._wrap(g) for g in results]


class no_grad_decorator:
    """``paddle.no_grad``: ``with paddle.no_grad():``, ``with
    paddle.no_grad:``, ``@paddle.no_grad()`` and ``@paddle.no_grad``."""

    def __call__(self, func=None):
        if func is None:
            return no_grad_decorator()

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with torch.no_grad():
                return func(*args, **kwargs)
        return wrapper

    def __enter__(self):
        # a stack: the module-level object is re-entered by nested blocks
        stack = self.__dict__.setdefault("_stack", [])
        stack.append(torch.is_grad_enabled())
        torch.set_grad_enabled(False)

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._stack.pop())
        return False


no_grad = no_grad_decorator()
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """Transform what autograd keeps for the backward: ``pack_hook``
    receives each saved tensor as a Paddle tensor, ``unpack_hook`` what
    ``pack_hook`` returned, and gives a tensor back (torch's
    ``saved_tensors_hooks``, which packs exactly the tensors saved for the
    backward, as Paddle does; the reference packs every input of a recorded
    op)."""

    def __init__(self, pack_hook, unpack_hook):
        super().__init__(lambda t: pack_hook(Tensor._wrap(t)),
                         lambda p: _data(unpack_hook(p)))
