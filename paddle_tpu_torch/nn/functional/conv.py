"""``conv2d``: the port of ``paddle_tpu/nn/functional/conv.py::conv2d``.

The weight keeps the reference's layout, ``[out, in / groups, kh, kw]``
(OIHW), in either data format, so weights carry over as they are. An NHWC
tensor ``[N, H, W, C]`` is, viewed as NCHW, a ``torch.channels_last``
tensor: the convolution takes that view (a permute that moves no data) and
hands back the NHWC view of its channels-last output, so an NHWC network
runs channels-last end to end without a copy between layers. Padding is an
int or one int per spatial side pair (``(ph, pw)``); the reference's string
paddings ("SAME", "VALID") wait for ROADMAP queue 1 item 5d.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["conv2d", "check_format", "to_nchw", "from_nchw"]

_FORMATS = ("NCHW", "NHWC")


def check_format(data_format: str) -> bool:
    """True for NHWC, False for NCHW; anything else raises."""
    if data_format not in _FORMATS:
        raise ValueError(f"data_format must be one of {_FORMATS}, got "
                         f"{data_format!r}")
    return data_format == "NHWC"


def to_nchw(x, nhwc: bool):
    """The NCHW view of ``x`` (channels-last strides when ``x`` is a
    contiguous NHWC tensor)."""
    return x.permute(0, 3, 1, 2) if nhwc else x


def from_nchw(y, nhwc: bool):
    """The NHWC view of an NCHW result (contiguous when ``y`` is
    channels-last)."""
    return y.permute(0, 2, 3, 1) if nhwc else y


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x`` (``[N, C, H, W]`` or, with
    ``data_format="NHWC"``, ``[N, H, W, C]``) by an OIHW ``weight``. It
    dispatches through ``__torch_function__``, so the port's AMP casts its
    inputs under the reference's op name ``conv2d`` (white-listed)."""
    args = (x, weight) + (() if bias is None else (bias,))
    if has_torch_function(args):
        return handle_torch_function(
            conv2d, args, x, weight, bias=bias, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            data_format=data_format)
    nhwc = check_format(data_format)
    if isinstance(padding, str):
        raise NotImplementedError(
            f"string padding {padding!r} is not ported yet (ROADMAP queue 1 "
            f"item 5d: the rest of the surface)")
    y = F.conv2d(to_nchw(x, nhwc), weight, bias, stride, padding, dilation,
                 groups)
    return from_nchw(y, nhwc)

