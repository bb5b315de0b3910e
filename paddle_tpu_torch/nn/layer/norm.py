"""Norm layers: the port of ``paddle_tpu/nn/layer/norm.py``.

The batch norms (``BatchNorm``, ``BatchNorm1D/2D/3D``, ``SyncBatchNorm``)
are ``_BatchNormBase`` (``:14-50``) over ``nn.functional.batch_norm``
(Paddle's momentum, the biased variance in the running statistic). The
buffers keep the reference's names, ``_mean`` (zeros) and ``_variance``
(ones), and stay float32 whatever the layer's dtype, as the reference's;
``weight`` (ones) and ``bias`` (zeros) are the affine parameters, made as
``weight_attr``/``bias_attr`` say. ``train()`` and ``eval()`` pick batch or
running statistics, as the reference's ``training`` flag;
``use_global_stats`` overrides them. ``SyncBatchNorm`` is the batch norm of
one device, as the reference's eager path.

The port's models build the batch norm on an explicit ``device``/``dtype``
(``vision/models/resnet.py``) and draw its values in
:meth:`_BatchNormBase.reset_parameters`.

``LayerNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D`` (``scale`` and
``bias``, or neither), ``LocalResponseNorm`` and ``SpectralNorm`` (no
state: its power iteration starts from ones, as the reference's) complete
the file.
"""
from __future__ import annotations

import torch

from ...core.tensor import Parameter
from ...framework.device import current_device
from .. import functional as F
from .. import initializer as I
from ..functional.conv import check_format
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        check_format(data_format)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if device is not None:
            self.weight = Parameter(torch.ones(num_features, device=device,
                                               dtype=dtype))
            self.bias = Parameter(torch.zeros(num_features, device=device,
                                              dtype=dtype))
        else:
            self.weight = create_parameter_with_attr(
                [num_features], self._dtype, weight_attr, False,
                default_initializer=I.Constant(1.0))
            self.bias = create_parameter_with_attr(
                [num_features], self._dtype, bias_attr, True,
                default_initializer=I.Constant(0.0))
            device = current_device()
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self._parameters["weight"].fill_(1.0)
        self._parameters["bias"].zero_()
        self._buffers["_mean"].zero_()
        self._buffers["_variance"].fill_(1.0)

    def forward(self, input):  # noqa: A002 - the reference's argument name
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"{self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm with the statistics of one device (the reference's eager
    path)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` holding its values."""
        converted = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            converted = cls(layer._num_features, layer._momentum,
                            layer._epsilon, data_format=layer._data_format)
            converted.set_state_dict(layer.state_dict())
        for name, sub in list(layer.named_children()):
            setattr(converted, name, cls.convert_sync_batchnorm(sub))
        return converted


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = [int(s) for s in normalized_shape]
        self._epsilon = epsilon
        self.weight = create_parameter_with_attr(
            self._normalized_shape, self._dtype, weight_attr, False,
            default_initializer=I.Constant(1.0))
        self.bias = create_parameter_with_attr(
            self._normalized_shape, self._dtype, bias_attr, True,
            default_initializer=I.Constant(0.0))

    def forward(self, input):  # noqa: A002
        return F.layer_norm(input, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = create_parameter_with_attr(
            [num_channels], self._dtype, weight_attr, False,
            default_initializer=I.Constant(1.0))
        self.bias = create_parameter_with_attr(
            [num_channels], self._dtype, bias_attr, True,
            default_initializer=I.Constant(0.0))

    def forward(self, input):  # noqa: A002
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False or bias_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = create_parameter_with_attr(
                [num_features], self._dtype, weight_attr, False,
                default_initializer=I.Constant(1.0))
            self.bias = create_parameter_with_attr(
                [num_features], self._dtype, bias_attr, True,
                default_initializer=I.Constant(0.0))

    def forward(self, input):  # noqa: A002
        return F.instance_norm(input, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.local_response_norm(input, self.size, self.alpha,
                                     self.beta, self.k, self.data_format)


class SpectralNorm(Layer):
    """The weight passed to :meth:`forward` over its spectral norm
    (``nn.functional.spectral_norm``)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon

    def forward(self, weight):
        return F.spectral_norm(weight, self.dim, self.power_iters,
                               self.epsilon)
