"""Pooling: the port of ``paddle_tpu/nn/functional/pooling.py``.

Each pool runs behind :func:`core.dispatch.apply_op` under the reference's
op name (``max_pool2d``, ``avg_pool1d``, ``adaptive_avg_pool2d``, ...; on
neither AMP list: O2 casts the input to the amp dtype, O1 leaves it), in
either data format (a channels-last input through its channels-first view,
as the convolutions).

- Max and average pools take the reference's paddings (an int, per axis,
  ``(lo, hi)`` pairs, "SAME", "VALID"): torch's pool pads symmetric pads
  of at most half the kernel itself; others are applied with ``F.pad``
  (-inf for max, zeros for average) before it. ``exclusive`` averages over
  the elements that are not padding; otherwise over the whole window.
  ``ceil_mode`` is honoured, as Paddle does (the reference ignores it).
- ``return_mask`` gives each output's argmax as a flat index into its
  input plane (the first of equal maxima), which ``max_unpool*d``
  consumes; channel-first layouts only, as the reference
  (``:84-90``).
- Adaptive pools cut each axis into the bins ``[floor(j·in/out),
  ceil((j+1)·in/out))`` (torch's and the reference's bins); an
  ``output_size`` of None keeps the axis.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.dispatch import apply_op
from .conv import check_format, from_nchw, pad_spec, to_nchw

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}
_AMAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d,
         3: F.adaptive_max_pool3d}
_AAVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
         3: F.adaptive_avg_pool3d}
_UNPOOL = {1: F.max_unpool1d, 2: F.max_unpool2d, 3: F.max_unpool3d}


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _torch_pad(pairs):
    return [v for lo_hi in reversed(pairs) for v in lo_hi]


def _window(n, a, kernel_size, stride, padding):
    """``(kernel, stride, [(lo, hi)] pads, the symmetric pads torch's pool
    takes itself or None)``: torch pads a side by at most half the
    kernel."""
    k = _tuple(kernel_size, n)
    s = _tuple(stride, n) if stride is not None else k
    pairs = pad_spec(padding, n, s, a.shape[2:], k, (1,) * n)
    own = tuple(lo for lo, _ in pairs)
    if any(lo != hi for lo, hi in pairs) or any(
            lo > kk // 2 for lo, kk in zip(own, k)):
        own = None
    return k, s, pairs, own


def _max_pool(n, x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format):
    last = check_format(data_format)
    if return_mask and last:
        raise NotImplementedError(
            f"return_mask supports NC* layouts only, got {data_format}")

    def fn(a):
        ac = to_nchw(a, last)
        k, s, pairs, own = _window(n, ac, kernel_size, stride, padding)
        if own is not None:
            out = _MAX[n](ac, k, s, own, ceil_mode=ceil_mode,
                          return_indices=return_mask)
            return out if return_mask else from_nchw(out, last)
        padded = F.pad(ac, _torch_pad(pairs), value=-float("inf"))
        if not return_mask:
            return from_nchw(_MAX[n](padded, k, s, 0, ceil_mode=ceil_mode),
                             last)
        out, idx = _MAX[n](padded, k, s, 0, ceil_mode=ceil_mode,
                           return_indices=True)
        # a flat index into the padded plane, as one into the input's
        coords, flat = [], idx
        for d in reversed(range(n)):
            coords.append(flat % padded.shape[2 + d] - pairs[d][0])
            flat = flat // padded.shape[2 + d]
        mask = torch.zeros_like(idx)
        for d in range(n):
            mask = mask * ac.shape[2 + d] + coords[n - 1 - d]
        return out, mask
    return apply_op(f"max_pool{n}d", fn, x)


def _avg_pool(n, x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format):
    last = check_format(data_format)

    def fn(a):
        ac = to_nchw(a, last)
        k, s, pairs, own = _window(n, ac, kernel_size, stride, padding)
        if own is not None and divisor_override is None and (
                exclusive or not ceil_mode):
            pool = F.avg_pool1d if n == 1 else _AVG[n]
            return from_nchw(pool(ac, k, s, own, ceil_mode=ceil_mode,
                                  count_include_pad=not exclusive), last)
        if n == 1:          # torch's 1-D pool takes no divisor: pool in 2-D
            ac, k, s, pairs = ac.unsqueeze(-2), (1,) + k, (1,) + s, \
                [(0, 0)] + pairs
        flat = _torch_pad(pairs)

        def window_sum(t):
            return _AVG[len(k)](F.pad(t, flat), k, s, 0, ceil_mode=ceil_mode,
                                divisor_override=1)
        summed = window_sum(ac)
        if divisor_override:
            out = summed / divisor_override
        elif exclusive:
            ones = torch.ones((1, 1) + ac.shape[2:], dtype=ac.dtype,
                              device=ac.device)
            out = summed / window_sum(ones)
        else:
            out = summed / float(np.prod(k))
        if n == 1:
            out = out.squeeze(-2)
        return from_nchw(out, last)
    return apply_op(f"avg_pool{n}d", fn, x)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(1, x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over windows of ``kernel_size`` (``stride`` defaults to it),
    padded with -inf."""
    return _max_pool(2, x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(3, x, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(1, x, kernel_size, stride, padding, ceil_mode,
                     exclusive, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(2, x, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(3, x, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def _osize(output_size, n):
    if output_size is None or isinstance(output_size, (int, np.integer)):
        return (output_size,) * n
    return tuple(None if o is None else int(o) for o in output_size)


def _adaptive(n, x, output_size, mode, data_format, return_mask=False):
    last = check_format(data_format)

    def fn(a):
        ac = to_nchw(a, last)
        size = _osize(output_size, n)
        if mode == "avg":
            return from_nchw(_AAVG[n](ac, size), last)
        return _AMAX[n](ac, size, return_indices=return_mask)
    return apply_op(f"adaptive_{mode}_pool{n}d", fn, x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(1, x, output_size, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the adaptive windows that cut the plane into
    ``output_size`` cells."""
    return _adaptive(2, x, output_size, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(3, x, output_size, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(1, x, output_size, "max", "NCL", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(2, x, output_size, "max", "NCHW", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(3, x, output_size, "max", "NCDHW", return_mask)


def _unpool(n, x, indices, kernel_size, stride, padding, output_size,
            data_format):
    """Each pooled value back at its argmax position (zeros elsewhere); the
    output plane is ``(in - 1)·stride - 2·padding + kernel`` unless
    ``output_size`` says."""
    if not data_format.startswith("NC"):
        raise NotImplementedError(
            f"max_unpool supports NC* layouts only, got {data_format}")
    k = _tuple(kernel_size, n)
    s = _tuple(stride, n) if stride is not None else k
    p = _tuple(padding, n)

    def fn(a, idx):
        if output_size is not None:
            size = tuple(int(d) for d in output_size[-n:])
        else:
            size = tuple((a.shape[2 + d] - 1) * s[d] - 2 * p[d] + k[d]
                         for d in range(n))
        return _UNPOOL[n](a, idx.long(), k, s, p, output_size=size)
    return apply_op(f"max_unpool{n}d", fn, x, indices)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(1, x, indices, kernel_size, stride, padding, output_size,
                   data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(2, x, indices, kernel_size, stride, padding, output_size,
                   data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(3, x, indices, kernel_size, stride, padding, output_size,
                   data_format)
