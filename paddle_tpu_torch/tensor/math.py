"""Elementwise and reduction math: the port of ``paddle_tpu/tensor/math.py``.

Each op is a torch function behind :func:`core.dispatch.apply_op`, under the
reference's op name (which ``amp.auto_cast`` reads)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import apply_op, inplace, unwrap
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        a = axis.numpy().tolist()
        return tuple(a) if isinstance(a, list) else int(a)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, axis):
    """``axis`` as a tuple of dims of ``a`` (all of them for None)."""
    ax = _axis(axis)
    if ax is None:
        return tuple(range(a.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _tdt(dtype):
    return dtype_mod.to_torch_dtype(dtype)


def _inplace(x, r):
    return inplace(x, r)


def _binop(op_name, fn):
    def op(x, y, name=None):  # noqa: A002 - `name` is Paddle's user label
        return apply_op(op_name, fn, x, y)
    op.__name__ = op_name
    return op


def _unop(op_name, fn):
    def op(x, name=None):  # noqa: A002
        return apply_op(op_name, fn, x)
    op.__name__ = op_name
    return op


def _as_like(b, a):
    return b if isinstance(b, torch.Tensor) else torch.as_tensor(
        b, dtype=a.dtype, device=a.device)


add = _binop("add", torch.add)
subtract = _binop("subtract", torch.subtract)
multiply = _binop("multiply", torch.multiply)
divide = _binop("divide", torch.true_divide)
floor_divide = _binop("floor_divide", torch.floor_divide)
remainder = _binop("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
maximum = _binop("maximum", lambda a, b: torch.maximum(a, _as_like(b, a)))
minimum = _binop("minimum", lambda a, b: torch.minimum(a, _as_like(b, a)))
fmax = _binop("fmax", lambda a, b: torch.fmax(a, _as_like(b, a)))
fmin = _binop("fmin", lambda a, b: torch.fmin(a, _as_like(b, a)))
atan2 = _binop("atan2", torch.atan2)
heaviside = _binop("heaviside", lambda a, b: torch.heaviside(
    a, _as_like(b, a)))
gcd = _binop("gcd", torch.gcd)
lcm = _binop("lcm", torch.lcm)
logaddexp = _binop("logaddexp", lambda a, b: torch.logaddexp(
    a, _as_like(b, a)))
nextafter = _binop("nextafter", lambda a, b: torch.nextafter(
    a, _as_like(b, a)))
copysign = _binop("copysign", torch.copysign)
hypot = _binop("hypot", lambda a, b: torch.hypot(a, _as_like(b, a)))


def pow(x, y, name=None):  # noqa: A001
    return apply_op("pow", torch.pow, x, y)


def divide_no_nan(x, y, name=None):
    def fn(a, b):
        b = _as_like(b, a)
        zero = b == 0
        return torch.where(zero, torch.zeros((), dtype=a.dtype,
                                             device=a.device),
                           a / torch.where(zero, torch.ones_like(b), b))
    return apply_op("divide_no_nan", fn, x, y)


abs = _unop("abs", torch.abs)  # noqa: A001
neg = _unop("neg", torch.neg)
exp = _unop("exp", torch.exp)
expm1 = _unop("expm1", torch.expm1)
log = _unop("log", torch.log)
log2 = _unop("log2", torch.log2)
log10 = _unop("log10", torch.log10)
log1p = _unop("log1p", torch.log1p)
sqrt = _unop("sqrt", torch.sqrt)
rsqrt = _unop("rsqrt", torch.rsqrt)
square = _unop("square", torch.square)
sin = _unop("sin", torch.sin)
cos = _unop("cos", torch.cos)
tan = _unop("tan", torch.tan)
asin = _unop("asin", torch.asin)
acos = _unop("acos", torch.acos)
atan = _unop("atan", torch.atan)
sinh = _unop("sinh", torch.sinh)
cosh = _unop("cosh", torch.cosh)
tanh = _unop("tanh", torch.tanh)
asinh = _unop("asinh", torch.asinh)
acosh = _unop("acosh", torch.acosh)
atanh = _unop("atanh", torch.atanh)
floor = _unop("floor", torch.floor)
ceil = _unop("ceil", torch.ceil)
round = _unop("round", torch.round)  # noqa: A001
trunc = _unop("trunc", torch.trunc)
sign = _unop("sign", torch.sign)
reciprocal = _unop("reciprocal", torch.reciprocal)
erf = _unop("erf", torch.special.erf)
erfinv = _unop("erfinv", torch.special.erfinv)
digamma = _unop("digamma", torch.special.digamma)
lgamma = _unop("lgamma", torch.lgamma)
frac = _unop("frac", lambda a: a - torch.trunc(a))
deg2rad = _unop("deg2rad", torch.deg2rad)
rad2deg = _unop("rad2deg", torch.rad2deg)
angle = _unop("angle", torch.angle)
conj = _unop("conj", lambda a: torch.conj(a).resolve_conj())
real = _unop("real", lambda a: torch.real(a).clone() if a.is_complex()
             else a.clone())
imag = _unop("imag", lambda a: torch.imag(a).clone() if a.is_complex()
             else torch.zeros_like(a))
i0 = _unop("i0", torch.special.i0)
i1 = _unop("i1", torch.special.i1)


def isfinite(x, name=None):
    return apply_op("isfinite", torch.isfinite, x)


def isnan(x, name=None):
    return apply_op("isnan", torch.isnan, x)


def isinf(x, name=None):
    return apply_op("isinf", torch.isinf, x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    def _scale(a, s, b):
        return a * s + b if bias_after_scale else (a + b) * s
    r = apply_op("scale", _scale, x, scale, bias)
    if act is not None:
        from ..nn import functional as F
        r = getattr(F, act)(r)
    return r


def increment(x, value=1.0, name=None):
    return _inplace(x, apply_op("increment", lambda a: a + value, x))


def clip(x, min=None, max=None, name=None):  # noqa: A002
    def fn(a, lo, hi):
        if lo is None and hi is None:
            return a.clone()
        return torch.clamp(a, lo, hi)
    return apply_op("clip", fn, x, unwrap(min), unwrap(max))


def lerp(x, y, weight, name=None):
    return apply_op("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def multiplex(inputs, index, name=None):
    def _mux(idx, *xs):
        stacked = torch.stack(xs, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]
    return apply_op("multiplex", _mux, index, *inputs)


# ---------------- reductions ----------------

def _reduce(fn, a, axis, keepdim, **kw):
    dims = _dims(a, axis)
    if not dims:
        return fn(a, dim=(), keepdim=keepdim, **kw) if a.dim() else \
            fn(a.reshape(1), dim=0, **kw).reshape(())
    return fn(a, dim=dims, keepdim=keepdim, **kw)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    return apply_op("sum", lambda a: _reduce(torch.sum, a, axis, keepdim,
                                             dtype=_tdt(dtype)), x)


def mean(x, axis=None, keepdim=False, name=None):
    return apply_op("mean", lambda a: _reduce(torch.mean, a, axis,
                                              keepdim), x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    def fn(a):
        if dtype is not None:
            a = a.to(_tdt(dtype))
        for d in sorted((d % builtins.max(a.dim(), 1)
                         for d in _dims(a, axis)), reverse=True):
            a = torch.prod(a, dim=d, keepdim=keepdim)
        return a if a.dim() or not keepdim else a
    return apply_op("prod", fn, x)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op("max", lambda a: _reduce(torch.amax, a, axis, keepdim),
                    x)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op("min", lambda a: _reduce(torch.amin, a, axis, keepdim),
                    x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim, name)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim, name)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply_op("nansum", lambda a: _reduce(
        torch.nansum, a, axis, keepdim, dtype=_tdt(dtype)), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply_op("nanmean", lambda a: _reduce(torch.nanmean, a, axis,
                                                 keepdim), x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply_op("logsumexp", lambda a: torch.logsumexp(
        a, dim=_dims(a, axis), keepdim=keepdim), x)


def cumsum(x, axis=None, dtype=None, name=None):
    def fn(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=_tdt(dtype))
        return torch.cumsum(a, int(axis), dtype=_tdt(dtype))
    return apply_op("cumsum", fn, x)


def cumprod(x, dim=None, dtype=None, name=None):
    def fn(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=_tdt(dtype))
        return torch.cumprod(a, int(dim), dtype=_tdt(dtype))
    return apply_op("cumprod", fn, x)


def _cumext(op_name, fn_t):
    def op(x, axis=None, dtype="int64", name=None):  # noqa: A002
        def fn(a):
            aa = a.reshape(-1) if axis is None else a
            vals, idx = fn_t(aa, 0 if axis is None else int(axis))
            return vals, idx.to(_tdt(dtype))
        return apply_op(op_name, fn, x)
    op.__name__ = op_name
    return op


cummax = _cumext("cummax", torch.cummax)
cummin = _cumext("cummin", torch.cummin)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def fn(a, pre, app):
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)
    return apply_op("diff", fn, x, prepend, append)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply_op("trapezoid", lambda yy, xx: torch.trapezoid(
            yy, xx, dim=axis), y, x)
    d = 1.0 if dx is None else dx
    return apply_op("trapezoid", lambda yy: torch.trapezoid(
        yy, dx=d, dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def fn(yy, xx=None):
        y1 = torch.movedim(yy, axis, -1)
        if xx is not None:
            x1 = torch.movedim(xx, axis, -1) if xx.dim() == yy.dim() else xx
            dxs = torch.diff(x1, dim=-1)
        else:
            dxs = dx if dx is not None else 1.0
        avg = (y1[..., 1:] + y1[..., :-1]) / 2.0
        return torch.movedim(torch.cumsum(avg * dxs, -1), -1, axis)
    if x is not None:
        return apply_op("cumulative_trapezoid", fn, y, x)
    return apply_op("cumulative_trapezoid", fn, y)


# ---------------- matrix-ish convenience (the rest is in linalg.py) -------

def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return apply_op("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                    input, x, y)


def inner(x, y, name=None):
    return apply_op("inner", torch.inner, x, y)


def outer(x, y, name=None):
    return apply_op("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                      b.reshape(-1)), x, y)


def kron(x, y, name=None):
    return apply_op("kron", torch.kron, x, y)


def inverse(x, name=None):
    return apply_op("inverse", torch.linalg.inv, x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op("diagonal", lambda a: torch.diagonal(
        a, offset, axis1, axis2).clone(), x)


# ---------------- in-place variants ----------------

def _make_inplace(fn):
    def op_(x, *args, **kwargs):
        return _inplace(x, fn(x, *args, **kwargs))
    op_.__name__ = fn.__name__ + "_"
    return op_


add_ = _make_inplace(add)
subtract_ = _make_inplace(subtract)
multiply_ = _make_inplace(multiply)
divide_ = _make_inplace(divide)
scale_ = _make_inplace(scale)
clip_ = _make_inplace(clip)
exp_ = _make_inplace(exp)
sqrt_ = _make_inplace(sqrt)
rsqrt_ = _make_inplace(rsqrt)
reciprocal_ = _make_inplace(reciprocal)
round_ = _make_inplace(round)
floor_ = _make_inplace(floor)
ceil_ = _make_inplace(ceil)
neg_ = _make_inplace(neg)
abs_ = _make_inplace(abs)
tanh_ = _make_inplace(tanh)
erfinv_ = _make_inplace(erfinv)
remainder_ = _make_inplace(remainder)
floor_divide_ = _make_inplace(floor_divide)
lerp_ = _make_inplace(lerp)
pow_ = _make_inplace(pow)


def sgn(x, name=None):
    return apply_op("sgn", torch.sgn, x)


def logit(x, eps=None, name=None):
    def fn(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a) - torch.log1p(-a)
    return apply_op("logit", fn, x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def fn(a):
        ax = -1 if axis is None else int(axis)
        if axis is None:
            a = a.reshape(-1)
        m = torch.amax(a, dim=ax, keepdim=True)
        return m + torch.log(torch.cumsum(torch.exp(a - m), ax))
    return apply_op("logcumsumexp", fn, x)


def renorm(x, p, axis, max_norm, name=None):
    def fn(a):
        ax = axis % a.dim()
        dims = tuple(d for d in range(a.dim()) if d != ax)
        norms = torch.sum(torch.abs(a) ** p, dim=dims,
                          keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm,
                             max_norm / torch.clamp(norms, min=1e-12),
                             torch.ones_like(norms))
        return a * factor
    return apply_op("renorm", fn, x)


def add_n(inputs, name=None):
    """Elementwise sum of a list of tensors."""
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    if not inputs:
        raise ValueError("add_n expects at least one input")

    def fn(*arrs):
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out
    return apply_op("add_n", fn, *inputs)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply_op("count_nonzero", lambda a: _reduce(
        torch.sum, (a != 0).long(), axis, keepdim), x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), x)


def take(x, index, mode="raise", name=None):
    """Flat-index gather: negative indices wrap; ``mode`` "raise",
    "wrap" or "clip" treats indices out of range as numpy's ``take``."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"unknown take mode {mode}")
    if mode == "raise":
        idx = unwrap(index)
        n = x.size if isinstance(x, Tensor) else unwrap(x).numel()
        idx = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(idx)
        if idx.numel() and (int(idx.min()) < -n or int(idx.max()) >= n):
            raise ValueError("take: index out of range")

    def fn(a, idx):
        flat = a.reshape(-1)
        n = flat.shape[0]
        ii = idx.long()
        if mode == "wrap":
            ii = ii % n
        elif mode == "clip":
            ii = torch.clamp(ii, 0, n - 1)
        else:
            ii = torch.where(ii < 0, ii + n, ii)
        return flat[ii]
    return apply_op("take", fn, x, index)


def frexp(x, name=None):
    """Mantissa and exponent, ``x = m * 2**e`` with ``0.5 <= |m| < 1``
    (the reference's formula, its exponent in x's dtype)."""
    def fn(a):
        safe = torch.where(a == 0, torch.ones_like(a), a)
        e = torch.where(a == 0, torch.zeros_like(a),
                        torch.floor(torch.log2(torch.abs(safe))) + 1)
        e1 = torch.ceil(e / 2)
        m = (a * torch.exp2(-e1)) * torch.exp2(-(e - e1))
        return m, e
    return apply_op("frexp", fn, x)


def polar(abs, angle, name=None):  # noqa: A002
    """A complex tensor from magnitude and phase (float32 → complex64,
    float64 → complex128)."""
    return apply_op("polar", torch.polar, abs, angle)


def broadcast_shape(x_shape, y_shape):
    """The broadcast of two static shapes."""
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
