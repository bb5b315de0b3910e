"""Weight initializers: the port of ``paddle_tpu/nn/initializer/__init__.py``.

Each initializer is a callable ``(shape, torch dtype) -> torch.Tensor`` on
:func:`framework.device.current_device`, drawing from the port's generator
(``framework/random.py``), and is usable through ``ParamAttr`` as the
reference's. The deterministic ones (``Constant``, ``Assign``, ``Dirac``,
``Bilinear``) give the reference's values exactly; the random ones its
distributions, from torch's stream.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import random as random_mod
from ...framework.device import current_device

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "Bilinear", "constant", "normal",
           "uniform", "set_global_initializer", "calculate_gain"]


def _gen(device):
    """The port's generator of ``device`` (none for ``meta``, where a
    ``LazyGuard`` puts parameters: nothing is drawn there)."""
    if torch.device(device).type == "meta":
        return None
    return random_mod.default_generator().for_device(device)


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *spatial] (Paddle's layout)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        dev = current_device()
        return self.mean + self.std * torch.randn(
            tuple(shape), dtype=dtype, device=dev, generator=_gen(dev))


class TruncatedNormal(Initializer):
    """N(mean, std²) truncated to two standard deviations."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        dev = current_device()
        t = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        # inverse CDF of a uniform draw over the truncated range
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
            (1 + math.erf(2 / math.sqrt(2))) / 2
        t.uniform_(lo, hi, generator=_gen(dev))
        t = torch.special.erfinv(2 * t - 1) * math.sqrt(2)
        return (self.mean + self.std * t.clamp(-2.0, 2.0)).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        dev = current_device()
        t = torch.empty(tuple(shape), dtype=dtype, device=dev)
        return t.uniform_(self.low, self.high, generator=_gen(dev))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return Normal(0.0, std)(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value
        arr = v.numpy() if hasattr(v, "numpy") and not isinstance(
            v, np.ndarray) else np.asarray(v)
        return torch.as_tensor(np.asarray(arr)).to(
            device=current_device(), dtype=dtype).reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        shape = tuple(shape)
        rows, cols = shape[0], int(np.prod(shape[1:]))
        dev = current_device()
        a = torch.randn(max(rows, cols), min(rows, cols), dtype=torch.float32,
                        device=dev, generator=_gen(dev))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        arr = np.zeros(shape, np.float32)
        centers = [s // 2 for s in shape[2:]]
        for i in range(min(shape[0], shape[1])):
            arr[(i, i) + tuple(centers)] = 1.0
        return torch.as_tensor(arr).to(device=current_device(), dtype=dtype)


class Bilinear(Initializer):
    """The bilinear-upsampling kernel for a ``[C_out, C_in, kH, kW]``
    transposed-conv weight, in every channel pair."""

    def __call__(self, shape, dtype):
        shape = tuple(shape)
        if len(shape) != 4:
            raise ValueError(f"Bilinear initializer expects a 4-D conv "
                             f"weight, got rank {len(shape)}")
        kh, kw = shape[2], shape[3]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = f_h - 1 if kh % 2 == 1 else f_h - 0.5
        c_w = f_w - 1 if kw % 2 == 1 else f_w - 0.5
        og = np.ogrid[:kh, :kw]
        filt = (1 - np.abs(og[0] - c_h) / f_h) * (1 - np.abs(og[1] - c_w)
                                                  / f_w)
        w = np.broadcast_to(filt.astype(np.float32), shape).copy()
        return torch.as_tensor(w).to(device=current_device(), dtype=dtype)


constant = Constant
normal = Normal
uniform = Uniform

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def global_initializer(is_bias):
    return _global_bias_init if is_bias else _global_weight_init


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]
