"""Search and sort ops: the port of ``paddle_tpu/tensor/search.py``."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op, unwrap
from ..framework import dtype as dtype_mod
from .math import _inplace


def _arg(op_name, fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):  # noqa
        tdt = dtype_mod.to_torch_dtype(dtype)

        def f(a):
            if axis is None:
                return fn(a.reshape(-1)).to(tdt)
            return fn(a, dim=int(axis), keepdim=keepdim).to(tdt)
        return apply_op(op_name, f, x)
    op.__name__ = op_name
    return op


argmax = _arg("argmax", torch.argmax)
argmin = _arg("argmin", torch.argmin)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    # descending is the stable ascending order reversed, as the reference
    def fn(a):
        r = torch.argsort(a, dim=axis, stable=True)
        return torch.flip(r, [axis]) if descending else r
    return apply_op("argsort", fn, x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def fn(a):
        r = torch.sort(a, dim=axis, stable=True).values
        return torch.flip(r, [axis]) if descending else r
    return apply_op("sort", fn, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa
    k = int(unwrap(k))

    def fn(a):
        r = torch.topk(a, k, dim=-1 if axis is None else int(axis),
                       largest=largest, sorted=True)
        return r.values, r.indices
    return apply_op("topk", fn, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(a):
        idx = torch.argsort(a, dim=axis, stable=True).narrow(axis, k - 1, 1)
        v = torch.take_along_dim(a, idx, axis)
        if not keepdim:
            v, idx = v.squeeze(axis), idx.squeeze(axis)
        return v, idx
    return apply_op("kthvalue", fn, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index of its last occurrence, as the
    reference."""
    def fn(a):
        moved = torch.movedim(a, axis, -1)
        srt = torch.sort(moved, dim=-1).values
        n = srt.shape[-1]
        counts = (srt[..., :, None] == srt[..., None, :]).sum(-1)
        best = torch.argmax(counts, dim=-1, keepdim=True)
        vals = torch.take_along_dim(srt, best, -1)[..., 0]
        pos = torch.arange(1, n + 1, device=a.device)
        idx = torch.argmax((moved == vals[..., None]).long() * pos, dim=-1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx
    return apply_op("mode", fn, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def fn(c, a, b):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, device=c.device)
        return torch.where(c.bool(), a, b)
    return apply_op("where", fn, condition, x, y)


def where_(condition, x, y, name=None):
    return _inplace(x, where(condition, x, y))


def nonzero(x, as_tuple=False):
    if as_tuple:
        return apply_op("nonzero", lambda a: tuple(torch.nonzero(
            a, as_tuple=True)), x)
    return apply_op("nonzero", torch.nonzero, x)


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms
    return _ms(x, mask, name)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_op("searchsorted", lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right, name)


def index_fill(x, index, axis, value, name=None):
    return apply_op("index_fill", lambda a, i: torch.index_fill(
        a, axis, i.reshape(-1).long(), value), x, index)
