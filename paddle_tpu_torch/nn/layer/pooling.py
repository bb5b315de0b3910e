"""``MaxPool2D`` and ``AdaptiveAvgPool2D``: the port of the reference's
(``paddle_tpu/nn/layer/pooling.py``), with ``data_format``, as
:class:`nn.Layer` s."""
from __future__ import annotations

from ..functional.conv import check_format
from ..functional.pooling import adaptive_avg_pool2d, max_pool2d
from .layers import Layer

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW", name=None):
        super().__init__()
        check_format(data_format)
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          self.ceil_mode, self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        check_format(data_format)
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self._output_size, self._data_format)
