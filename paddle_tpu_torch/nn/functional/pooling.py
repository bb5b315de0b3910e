"""``max_pool2d`` and ``adaptive_avg_pool2d``: the port of the reference's
(``paddle_tpu/nn/functional/pooling.py``) in either data format (NHWC
through the channels-last view, as ``conv2d``). Each dispatches through
``__torch_function__`` under the reference's op name, on neither AMP list:
O2 casts its input to the amp dtype, O1 leaves it. ``return_mask`` and the
other pools wait for ROADMAP queue 1 item 5d."""
from __future__ import annotations

import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from .conv import check_format, from_nchw, to_nchw

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over windows of ``kernel_size`` (``stride`` defaults to it),
    padded with -inf."""
    if has_torch_function((x,)):
        return handle_torch_function(
            max_pool2d, (x,), x, kernel_size, stride=stride, padding=padding,
            ceil_mode=ceil_mode, data_format=data_format)
    nhwc = check_format(data_format)
    y = F.max_pool2d(to_nchw(x, nhwc), kernel_size,
                     stride if stride is not None else kernel_size, padding,
                     ceil_mode=ceil_mode)
    return from_nchw(y, nhwc)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the adaptive windows that cut the plane into
    ``output_size`` cells."""
    if has_torch_function((x,)):
        return handle_torch_function(adaptive_avg_pool2d, (x,), x,
                                     output_size, data_format=data_format)
    nhwc = check_format(data_format)
    return from_nchw(F.adaptive_avg_pool2d(to_nchw(x, nhwc), output_size),
                     nhwc)
