"""Activations: the port of ``paddle_tpu/nn/functional/activation.py``,
each a torch function behind :func:`core.dispatch.apply_op` under the
reference's op name."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import apply_op, inplace
from ...framework import dtype as dtype_mod
from ...framework import random as random_mod


def _unop(op_name, fn):
    def op(x, name=None):  # noqa: A002 - `name` is Paddle's user label
        return apply_op(op_name, fn, x)
    op.__name__ = op_name
    return op


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


relu = _unop("relu", torch.relu)
relu6 = _unop("relu6", TF.relu6)
sigmoid = _unop("sigmoid", torch.sigmoid)
tanh = _unop("tanh", torch.tanh)
silu = _unop("silu", TF.silu)
softsign = _unop("softsign", TF.softsign)
tanhshrink = _unop("tanhshrink", lambda a: a - torch.tanh(a))
mish = _unop("mish", lambda a: a * torch.tanh(TF.softplus(a)))
hardswish = _unop("hardswish", lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0)
                  / 6.0)


def relu_(x, name=None):
    return inplace(x, relu(x))


def gelu(x, approximate=False, name=None):
    return apply_op("gelu", lambda a: TF.gelu(
        a, approximate="tanh" if approximate else "none"), x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op("leaky_relu", lambda a: TF.leaky_relu(a, negative_slope),
                    x)


def elu(x, alpha=1.0, name=None):
    return apply_op("elu", lambda a: TF.elu(a, alpha), x)


def elu_(x, alpha=1.0, name=None):
    return inplace(x, elu(x, alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), x)


def celu(x, alpha=1.0, name=None):
    return apply_op("celu", lambda a: TF.celu(a, alpha), x)


def swish(x, name=None):
    return silu(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return apply_op("hardtanh", lambda a: torch.clamp(a, min, max), x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op("hardsigmoid", lambda a: torch.clamp(
        a * slope + offset, 0.0, 1.0), x)


def hardshrink(x, threshold=0.5, name=None):
    return apply_op("hardshrink", lambda a: torch.where(
        torch.abs(a) > threshold, a, _zero(a)), x)


def softshrink(x, threshold=0.5, name=None):
    return apply_op("softshrink", lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, _zero(a))), x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_op("softplus", lambda a: torch.where(
        a * beta > threshold, a, TF.softplus(a * beta) / beta), x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_op("thresholded_relu", lambda a: torch.where(
        a > threshold, a, torch.full((), value, dtype=a.dtype,
                                     device=a.device)), x)


def prelu(x, weight, data_format="NCHW", name=None):
    def fn(a, w):
        if w.numel() == 1:
            return torch.where(a >= 0, a, w.reshape(()) * a)
        shape = [1] * a.dim()
        shape[1 if data_format[1] == "C" else a.dim() - 1] = w.numel()
        return torch.where(a >= 0, a, w.reshape(shape) * a)
    return apply_op("prelu", fn, x, weight)


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    if training:
        def fn(a):
            slope = torch.empty_like(a).uniform_(
                lower, upper, generator=random_mod.default_generator()
                .for_device(a.device))
            return torch.where(a >= 0, a, slope * a)
        return apply_op("rrelu", fn, x)
    mid = (lower + upper) / 2.0
    return apply_op("rrelu", lambda a: torch.where(a >= 0, a, mid * a), x)


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        shape = list(a.shape[:ax]) + [groups, c // groups] + \
            list(a.shape[ax + 1:])
        return torch.amax(a.reshape(shape), dim=ax)
    return apply_op("maxout", fn, x)


def softmax(x, axis=-1, dtype=None, name=None):
    tdt = dtype_mod.to_torch_dtype(dtype)
    return apply_op("softmax", lambda a: torch.softmax(
        a if tdt is None else a.to(tdt), axis), x)


def softmax_(x, axis=-1, dtype=None, name=None):
    return inplace(x, softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    tdt = dtype_mod.to_torch_dtype(dtype)
    return apply_op("log_softmax", lambda a: torch.log_softmax(
        a if tdt is None else a.to(tdt), axis), x)


def log_sigmoid(x, name=None):
    return apply_op("log_sigmoid", TF.logsigmoid, x)


def glu(x, axis=-1, name=None):
    return apply_op("glu", lambda a: TF.glu(a, axis), x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    def fn(a):
        u = torch.empty_like(a).uniform_(
            generator=random_mod.default_generator().for_device(a.device))
        g = -torch.log(-torch.log(u.clamp(min=torch.finfo(a.dtype).tiny)))
        y = torch.softmax((a + g) / temperature, axis)
        if hard:
            hard_y = torch.zeros_like(y).scatter_(
                axis, y.argmax(axis, keepdim=True), 1.0)
            y = hard_y - y.detach() + y          # straight-through
        return y
    return apply_op("gumbel_softmax", fn, x)
