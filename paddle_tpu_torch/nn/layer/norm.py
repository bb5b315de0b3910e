"""``BatchNorm2D``: the port of ``paddle_tpu/nn/layer/norm.py::
_BatchNormBase`` (``:14-50``) through ``nn.functional.batch_norm`` (Paddle's
momentum, the biased variance in the running statistic). The buffers keep
the reference's names, ``_mean`` (zeros) and ``_variance`` (ones), and stay
float32 whatever the layer's dtype, as the reference's; ``weight`` (ones)
and ``bias`` (zeros) are its affine parameters. ``train()`` and ``eval()``
pick batch or running statistics, as the reference's ``training`` flag;
``use_global_stats`` overrides them."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.conv import check_format
from ..functional.norm import batch_norm

__all__ = ["BatchNorm2D"]


class BatchNorm2D(nn.Module):
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
        self.weight = nn.Parameter(torch.ones(num_features, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device,
                                             dtype=dtype))
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self._mean.zero_()
        self._variance.fill_(1.0)

    def forward(self, input):  # noqa: A002 - the reference's argument name
        return batch_norm(input, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"{self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")
