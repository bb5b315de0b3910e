"""Convolutions: the port of ``paddle_tpu/nn/functional/conv.py``
(``conv1d/2d/3d`` and their transposes).

The weight keeps the reference's layout in every data format: ``[out,
in / groups, k…]`` for a convolution, ``[in, out / groups, k…]`` for a
transposed one, so weights carry over as they are. A channels-last tensor
(``NLC``, ``NHWC``, ``NDHWC``) is, viewed channels-first, a tensor with
channels-last strides: the convolution takes that view (a ``movedim`` that
moves no data) and hands back the channels-last view of its output, so a
channels-last network runs so end to end without a copy between layers.

Padding is the reference's (``_pad_spec``, ``:23-48``): an int, one int a
spatial axis, a ``(lo, hi)`` pair a spatial axis, ``2n`` ints, or the
strings "SAME" (the output ``ceil(in / stride)``, the extra pad at the end)
and "VALID". Symmetric padding goes to torch's convolution; asymmetric
padding is applied first with ``F.pad``. A transposed convolution crops
(or zero-extends) its unpadded output by the pads and ``output_padding``;
``output_size``, when given, sets ``output_padding`` as Paddle does (the
reference ignores it).

Each dispatches through ``__torch_function__``, so the port's AMP casts its
inputs under the reference's op name (``conv2d`` and the others are
white-listed).
"""
from __future__ import annotations

import numpy as np
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "check_format", "to_nchw",
           "from_nchw", "pad_spec"]

_FORMATS = ("NCL", "NLC", "NCHW", "NHWC", "NCDHW", "NDHWC", "NC")


def check_format(data_format: str) -> bool:
    """True for a channels-last format, False for a channels-first one;
    anything else raises."""
    if data_format not in _FORMATS:
        raise ValueError(f"data_format must be one of {_FORMATS}, got "
                         f"{data_format!r}")
    return not data_format.startswith("NC")


def to_nchw(x, channel_last: bool):
    """The channels-first view of ``x`` (channels-last strides when ``x``
    is a contiguous channels-last tensor)."""
    return x.movedim(-1, 1) if channel_last else x


def from_nchw(y, channel_last: bool):
    """The channels-last view of a channels-first result (contiguous when
    ``y`` has channels-last strides)."""
    return y.movedim(1, -1) if channel_last else y


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def pad_spec(padding, n, strides, spatial, kernel, dilation):
    """``[(lo, hi)]`` a spatial axis, as the reference's ``_pad_spec``."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            out = []
            for i in range(n):
                eff_k = (kernel[i] - 1) * dilation[i] + 1
                out_dim = -(-spatial[i] // strides[i])
                total = max(0, (out_dim - 1) * strides[i] + eff_k
                            - spatial[i])
                out.append((total // 2, total - total // 2))
            return out
        raise ValueError(f"bad padding {padding}")
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(int(v) for v in p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _torch_pad(pairs):
    """``F.pad``'s flat list (last axis first) of ``(lo, hi)`` pairs."""
    return [v for lo_hi in reversed(pairs) for v in lo_hi]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONVT = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
          3: F.conv_transpose3d}


def _conv_nd(fn, n, x, weight, bias, stride, padding, dilation, groups,
             data_format):
    args = (x, weight) + (() if bias is None else (bias,))
    if has_torch_function(args):
        return handle_torch_function(
            fn, args, x, weight, bias=bias, stride=stride, padding=padding,
            dilation=dilation, groups=groups, data_format=data_format)
    last = check_format(data_format)
    s, d = _tuple(stride, n), _tuple(dilation, n)
    xc = to_nchw(x, last)
    pairs = pad_spec(padding, n, s, xc.shape[2:], weight.shape[2:], d)
    if all(lo == hi for lo, hi in pairs):
        sym = tuple(lo for lo, _ in pairs)
    else:
        xc = F.pad(xc, _torch_pad(pairs))
        sym = 0
    return from_nchw(_CONV[n](xc, weight, bias, s, sym, d, groups), last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(conv1d, 1, x, weight, bias, stride, padding, dilation,
                    groups, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of ``x`` (``[N, C, H, W]`` or, with
    ``data_format="NHWC"``, ``[N, H, W, C]``) by an OIHW ``weight``."""
    return _conv_nd(conv2d, 2, x, weight, bias, stride, padding, dilation,
                    groups, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(conv3d, 3, x, weight, bias, stride, padding, dilation,
                    groups, data_format)


def _conv_transpose_nd(fn, n, x, weight, bias, stride, padding,
                       output_padding, groups, dilation, output_size,
                       data_format):
    args = (x, weight) + (() if bias is None else (bias,))
    if has_torch_function(args):
        return handle_torch_function(
            fn, args, x, weight, bias=bias, stride=stride, padding=padding,
            output_padding=output_padding, groups=groups, dilation=dilation,
            output_size=output_size, data_format=data_format)
    last = check_format(data_format)
    s, d = _tuple(stride, n), _tuple(dilation, n)
    opad = list(_tuple(output_padding, n))
    xc = to_nchw(x, last)
    k = weight.shape[2:]
    pairs = pad_spec(padding, n, s, xc.shape[2:], k, d)
    if output_size is not None:
        size = _tuple(output_size, n) if not isinstance(
            output_size, (list, tuple)) or len(output_size) == n else \
            _tuple(output_size[-n:], n)
        for i in range(n):
            base = (xc.shape[2 + i] - 1) * s[i] + (k[i] - 1) * d[i] + 1 \
                - pairs[i][0] - pairs[i][1]
            opad[i] = size[i] - base
            if not 0 <= opad[i] < max(s[i], d[i]):
                raise ValueError(
                    f"output_size {list(size)} is not reachable from input "
                    f"{list(xc.shape[2:])} with stride {list(s)}")
    if all(lo == hi for lo, hi in pairs) and all(
            o < max(si, di) for o, si, di in zip(opad, s, d)):
        y = _CONVT[n](xc, weight, bias, s, tuple(lo for lo, _ in pairs),
                      tuple(opad), groups, d)
    else:
        # the unpadded output, cropped by the pads (and extended by
        # output_padding, which adds positions no input reaches)
        y = _CONVT[n](xc, weight, None, s, 0, 0, groups, d)
        y = F.pad(y, _torch_pad([(-lo, o - hi)
                                 for (lo, hi), o in zip(pairs, opad)]))
        if bias is not None:
            y = y + bias.reshape((1, -1) + (1,) * n)
    return from_nchw(y, last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(conv1d_transpose, 1, x, weight, bias, stride,
                              padding, output_padding, groups, dilation,
                              output_size, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(conv2d_transpose, 2, x, weight, bias, stride,
                              padding, output_padding, groups, dilation,
                              output_size, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(conv3d_transpose, 3, x, weight, bias, stride,
                              padding, output_padding, groups, dilation,
                              output_size, data_format)
