"""Activation layers: the port of ``paddle_tpu/nn/layer/activation.py``."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer


def _make(name, fn, **fixed):
    class _Act(Layer):
        def __init__(self, name=None, **kwargs):
            super().__init__()
            self._kwargs = {**fixed, **{k: v for k, v in kwargs.items()
                                        if k != "name"}}

        def forward(self, x):
            return fn(x, **self._kwargs)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU", F.relu)
ReLU6 = _make("ReLU6", F.relu6)
Sigmoid = _make("Sigmoid", F.sigmoid)
Tanh = _make("Tanh", F.tanh)
Silu = _make("Silu", F.silu)
Swish = _make("Swish", F.swish)
Mish = _make("Mish", F.mish)
Hardswish = _make("Hardswish", F.hardswish)
Hardsigmoid = _make("Hardsigmoid", F.hardsigmoid)
Softsign = _make("Softsign", F.softsign)
Tanhshrink = _make("Tanhshrink", F.tanhshrink)
LogSigmoid = _make("LogSigmoid", F.log_sigmoid)


def _one(name, fn, *params):
    """A layer calling ``fn(x, *values)`` with ``params``' values, given
    positionally or by keyword (defaults as listed)."""
    keys = [k for k, _ in params]

    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            vals = dict(params)
            vals.update(zip(keys, args))
            vals.update({k: v for k, v in kwargs.items() if k in vals})
            self._vals = [vals[k] for k in keys]

        def forward(self, x):
            return fn(x, *self._vals)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


GELU = _one("GELU", F.gelu, ("approximate", False))
LeakyReLU = _one("LeakyReLU", F.leaky_relu, ("negative_slope", 0.01))
ELU = _one("ELU", F.elu, ("alpha", 1.0))
CELU = _one("CELU", F.celu, ("alpha", 1.0))
SELU = _one("SELU", F.selu, ("scale", 1.0507009873554805),
            ("alpha", 1.6732632423543772))
Hardtanh = _one("Hardtanh", F.hardtanh, ("min", -1.0), ("max", 1.0))
Hardshrink = _one("Hardshrink", F.hardshrink, ("threshold", 0.5))
Softshrink = _one("Softshrink", F.softshrink, ("threshold", 0.5))
Softplus = _one("Softplus", F.softplus, ("beta", 1.0), ("threshold", 20.0))
ThresholdedReLU = _one("ThresholdedReLU", F.thresholded_relu,
                       ("threshold", 1.0), ("value", 0.0))
Maxout = _one("Maxout", F.maxout, ("groups", None), ("axis", 1))
Softmax = _one("Softmax", F.softmax, ("axis", -1))
LogSoftmax = _one("LogSoftmax", F.log_softmax, ("axis", -1))
GLU = _one("GLU", F.glu, ("axis", -1))


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter_with_attr(
            [num_parameters], self._dtype, weight_attr, False,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softmax2D(Layer):
    """Softmax over the channels of an NCHW (or CHW) input."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)


__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
           "Hardswish", "Hardsigmoid", "Softsign", "Tanhshrink",
           "LogSigmoid", "GELU", "LeakyReLU", "ELU", "CELU", "SELU",
           "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
           "ThresholdedReLU", "Maxout", "Softmax", "LogSoftmax", "GLU",
           "RReLU", "PReLU", "Softmax2D"]
