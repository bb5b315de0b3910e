"""Pooling layers: the port of ``paddle_tpu/nn/layer/pooling.py`` (max and
average pools in 1-D, 2-D and 3-D, the adaptive pools and the unpools), as
:class:`nn.Layer` s over ``nn.functional``'s pools."""
from __future__ import annotations

from .. import functional as F
from ..functional.conv import check_format
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


class _PoolNd(Layer):
    _fn = None

    def __init__(self, kernel_size=None, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}
        if "data_format" in self.kwargs:
            check_format(self.kwargs["data_format"])

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              **self.kwargs)


class MaxPool1D(_PoolNd):
    _fn = F.max_pool1d


class MaxPool2D(_PoolNd):
    _fn = F.max_pool2d


class MaxPool3D(_PoolNd):
    _fn = F.max_pool3d


class AvgPool1D(_PoolNd):
    _fn = F.avg_pool1d


class AvgPool2D(_PoolNd):
    _fn = F.avg_pool2d


class AvgPool3D(_PoolNd):
    _fn = F.avg_pool3d


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self._output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        check_format(data_format)
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._output_size, self._data_format)


class _AdaptiveMax(Layer):
    _fn = None

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return type(self)._fn(x, self._output_size, self._return_mask)


class AdaptiveMaxPool1D(_AdaptiveMax):
    _fn = F.adaptive_max_pool1d


class AdaptiveMaxPool2D(_AdaptiveMax):
    _fn = F.adaptive_max_pool2d


class AdaptiveMaxPool3D(_AdaptiveMax):
    _fn = F.adaptive_max_pool3d


class _MaxUnPool(Layer):
    _fn = None
    _format = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding = padding
        self.data_format = data_format or self._format
        self.output_size = output_size

    def forward(self, x, indices):
        return type(self)._fn(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format,
                              self.output_size)


class MaxUnPool1D(_MaxUnPool):
    _fn, _format = F.max_unpool1d, "NCL"


class MaxUnPool2D(_MaxUnPool):
    _fn, _format = F.max_unpool2d, "NCHW"


class MaxUnPool3D(_MaxUnPool):
    _fn, _format = F.max_unpool3d, "NCDHW"
