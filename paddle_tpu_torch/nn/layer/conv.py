"""Convolution layers: the port of ``paddle_tpu/nn/layer/conv.py``
(``Conv1D/2D/3D`` and the ``*Transpose`` layers, ``:18-134``).

The weight keeps the reference's layout in every data format: ``[out,
in / groups, k…]``, or ``[in, out / groups, k…]`` for a transposed
convolution; the bias is ``[out]`` unless ``bias_attr=False``. As the
reference, the weight is drawn KaimingUniform over the fan-in ``in / groups
· prod(k)`` and the bias ``U(±1 / sqrt(fan_in))``, unless ``weight_attr``/
``bias_attr`` say otherwise. ``padding_mode`` other than "zeros" pads the
input ("reflect", "replicate", "circular") by ``padding`` first, as Paddle
does.

The port's models build a ``Conv2D`` on an explicit ``device``/``dtype``
(``vision/models/resnet.py``): its parameters start uninitialised and the
model draws them from its seed (:meth:`_ConvNd.reset_parameters`: the same
distributions, from a ``torch.Generator``). A :class:`nn.Layer`: ``weight``
and ``bias`` are Paddle parameters, and a torch tensor in gives a torch
tensor out."""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Parameter
from .. import functional as F
from .. import initializer as I
from ..functional.conv import check_format
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

_PAD_MODES = ("zeros", "reflect", "replicate", "circular")


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


class _ConvNd(Layer):
    def __init__(self, n, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, transposed=False, output_padding=0,
                 device=None, dtype=None):
        super().__init__()
        check_format(data_format)
        if padding_mode not in _PAD_MODES:
            raise ValueError(f"padding_mode must be one of {_PAD_MODES}, "
                             f"got {padding_mode!r}")
        self._n = n
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._transposed = transposed
        w_shape = [in_channels, out_channels // groups] if transposed else \
            [out_channels, in_channels // groups]
        w_shape += list(self.kernel_size)
        self._fan_in = (in_channels // groups) * int(np.prod(
            self.kernel_size))
        if device is not None:
            self.weight = Parameter(torch.empty(w_shape, device=device,
                                                dtype=dtype))
            self.bias = None if bias_attr is False else Parameter(
                torch.empty(out_channels, device=device, dtype=dtype))
            return
        bound = 1.0 / math.sqrt(self._fan_in)
        self.weight = create_parameter_with_attr(
            w_shape, self._dtype, weight_attr, False,
            default_initializer=I.KaimingUniform(fan_in=self._fan_in))
        self.bias = create_parameter_with_attr(
            [out_channels], self._dtype, bias_attr, True,
            default_initializer=I.Uniform(-bound, bound))

    @torch.no_grad()
    def reset_parameters(self, generator) -> None:
        """Draw the weight ``U(±sqrt(6 / fan_in))`` and the bias ``U(±1 /
        sqrt(fan_in))`` from ``generator``."""
        weight, bias = self._parameters["weight"], self._parameters.get("bias")
        limit = math.sqrt(6.0 / self._fan_in)
        weight.uniform_(-limit, limit, generator=generator)
        if bias is not None:
            bound = 1.0 / math.sqrt(self._fan_in)
            bias.uniform_(-bound, bound, generator=generator)

    def _padded(self, x):
        """``(input, padding)`` for the functional: the input padded by
        ``padding`` under a padding mode other than zeros."""
        if self.padding_mode == "zeros":
            return x, self.padding
        pads = _ntuple(self.padding, self._n)
        fmt = self.data_format
        return F.pad(x, [p for p in reversed(pads) for _ in (0, 1)],
                     mode=self.padding_mode, data_format=fmt), 0

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, data_format={self.data_format}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        x, pad = self._padded(x)
        return F.conv1d(x, self.weight, self.bias, self.stride, pad,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         dtype=dtype)

    def forward(self, x):
        x, pad = self._padded(x)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        x, pad = self._padded(x)
        return F.conv3d(x, self.weight, self.bias, self.stride, pad,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transposed=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)
