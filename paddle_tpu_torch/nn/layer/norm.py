"""``BatchNorm2D``: the port of ``paddle_tpu/nn/layer/norm.py::
_BatchNormBase`` (``:14-50``) through ``nn.functional.batch_norm`` (Paddle's
momentum, the biased variance in the running statistic). The buffers keep
the reference's names, ``_mean`` (zeros) and ``_variance`` (ones), and stay
float32 whatever the layer's dtype, as the reference's; ``weight`` (ones)
and ``bias`` (zeros) are its affine parameters. ``train()`` and ``eval()``
pick batch or running statistics, as the reference's ``training`` flag;
``use_global_stats`` overrides them.

``LayerNorm`` (``:85-103``): ``weight`` ones and ``bias`` zeros over
``normalized_shape``. Both are :class:`nn.Layer` s; the other norm layers
wait for ROADMAP queue 1 item 5d, part 2."""
from __future__ import annotations

import torch

from ...core.tensor import Parameter
from .. import initializer as I
from ..functional.conv import check_format
from ..functional.norm import batch_norm, layer_norm
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer

__all__ = ["BatchNorm2D", "LayerNorm"]


class BatchNorm2D(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        check_format(data_format)
        if weight_attr is not None or bias_attr is not None:
            raise NotImplementedError(
                "BatchNorm2D's weight_attr/bias_attr are not ported yet "
                "(ROADMAP queue 1 item 5d: the rest of the surface)")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = Parameter(torch.ones(num_features, device=device,
                                           dtype=dtype))
        self.bias = Parameter(torch.zeros(num_features, device=device,
                                          dtype=dtype))
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
        return batch_norm(input, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"{self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")


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
        return layer_norm(input, self._normalized_shape, self.weight,
                          self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")
