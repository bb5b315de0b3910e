"""``Conv2D``: the port of ``paddle_tpu/nn/layer/conv.py::Conv2D``
(``:18-104``). The weight is ``[out, in / groups, kh, kw]`` in either data
format (the reference's layout, so weights carry over untransposed), the
bias ``[out]`` unless ``bias_attr=False``. Parameters start uninitialised:
the model that owns the layer draws them from its seed
(:meth:`Conv2D.reset_parameters`: the reference's KaimingUniform weight,
``U(±sqrt(6 / fan_in))``, and ``U(±1 / sqrt(fan_in))`` bias). Other
``weight_attr``/``bias_attr`` objects and padding modes wait for ROADMAP
queue 1 item 5d, part 2. A :class:`nn.Layer`: ``weight`` and ``bias``
are Paddle parameters, and a torch tensor in gives a torch tensor out."""
from __future__ import annotations

import math

import torch

from ...core.tensor import Parameter
from ..functional.conv import check_format, conv2d
from .layers import Layer

__all__ = ["Conv2D"]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x)
                                                              for x in v)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__()
        check_format(data_format)
        if padding_mode != "zeros" or weight_attr is not None or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D takes padding_mode='zeros' and bias_attr None or "
                "False only (ROADMAP queue 1 item 5d: the rest of the "
                "surface)")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.data_format = data_format
        self.weight = Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size,
            device=device, dtype=dtype))
        self.bias = (None if bias_attr is False else Parameter(
            torch.empty(out_channels, device=device, dtype=dtype)))

    @torch.no_grad()
    def reset_parameters(self, generator) -> None:
        weight, bias = self._parameters["weight"], self._parameters.get("bias")
        fan_in = weight[0].numel()
        limit = math.sqrt(6.0 / fan_in)
        weight.uniform_(-limit, limit, generator=generator)
        if bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.data_format)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, data_format={self.data_format}")
