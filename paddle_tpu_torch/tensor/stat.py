"""Statistics: the port of ``paddle_tpu/tensor/stat.py``. The medians of
an even count average the two middle values (numpy's, the reference's):
they are the 0.5 quantile here, since ``torch.median`` takes the lower."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from .math import _axis, _reduce


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op("var", lambda a: _reduce(
        torch.var, a, axis, keepdim, correction=1 if unbiased else 0), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op("std", lambda a: _reduce(
        torch.std, a, axis, keepdim, correction=1 if unbiased else 0), x)


def _quantile(fn, a, q, axis, keepdim, interpolation):
    """``fn`` (torch.quantile or nanquantile) over several axes: they are
    moved last and flattened into one."""
    ax = _axis(axis)
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if ax is None:
        out = fn(a.reshape(-1), qt, dim=0, interpolation=interpolation)
        if keepdim:
            out = out.reshape(out.shape + (1,) * a.dim())
        return out
    dims = sorted(d % a.dim() for d in (ax if isinstance(ax, tuple)
                                        else (ax,)))
    rest = [d for d in range(a.dim()) if d not in dims]
    t = a.permute(rest + dims).reshape([a.shape[d] for d in rest] + [-1])
    out = fn(t, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        shape = list(out.shape[:out.dim() - len(rest)])
        kept = [1 if d in dims else a.shape[d] for d in range(a.dim())]
        out = out.reshape(shape + kept)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(a):
        if mode == "avg":
            return _quantile(torch.quantile, a, 0.5, axis, keepdim,
                             "linear")
        ax = _axis(axis)
        if ax is None:
            return torch.sort(a.reshape(-1)).values[(a.numel() - 1) // 2]
        srt = torch.sort(a, dim=ax).values
        val = srt.select(ax, (srt.shape[ax] - 1) // 2)
        return val.unsqueeze(ax) if keepdim else val
    return apply_op("median", fn, x)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply_op("nanmedian", lambda a: _quantile(
        torch.nanquantile, a, 0.5, axis, keepdim, "linear"), x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return apply_op("quantile", lambda a: _quantile(
        torch.quantile, a, q, axis, keepdim, interpolation), x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return apply_op("nanquantile", lambda a: _quantile(
        torch.nanquantile, a, q, axis, keepdim, interpolation), x)
