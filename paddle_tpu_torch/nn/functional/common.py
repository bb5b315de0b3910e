"""Common functionals: the port of ``paddle_tpu/nn/functional/common.py``.

Each runs behind :func:`core.dispatch.apply_op` under the reference's op
name (so the port's AMP casts it as the reference casts that name), or
dispatches through ``Tensor.__torch_function__``; a torch tensor in gives a
torch tensor out.

- ``dropout`` and its 2-D, 3-D and alpha forms draw their masks from the
  port's explicit generator (``framework/random.py``): the
  ``torch.Generator`` of the tensor's device inside ``generator``, or inside
  the default generator. ``dropout2d``/``dropout3d`` drop whole channels
  (the mask shared along the spatial axes), as the reference's.
- ``linear`` (Paddle's ``[in, out]`` weight) and ``embedding``
  (``padding_idx`` rows give zeros).
- ``interpolate`` is Paddle's function: ``align_corners`` and
  ``align_mode`` are honoured, "area" is an adaptive average pool, and a
  linear resize does not antialias. The reference ignores both flags, maps
  "area" to linear and calls ``jax.image.resize``, which antialiases when
  it downsamples (``paddle_tpu/nn/functional/common.py:163-194``); the two
  agree for "nearest" and for linear upsampling with ``align_corners=False``
  and ``align_mode=0`` (ROADMAP queue 3 lists the rest).
- ``grid_sample`` is Paddle's function too (``padding_mode`` honoured); the
  reference ignores ``padding_mode`` and clamps "nearest" to the border.
- ``class_center_sample`` raises, as the reference's.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch.overrides import handle_torch_function, has_torch_function

from ...core.dispatch import apply_op
from ...framework import random as random_mod

__all__ = ["dropout", "dropout2d", "dropout3d", "alpha_dropout", "keep_mask",
           "linear", "embedding", "one_hot", "label_smooth",
           "cosine_similarity", "bilinear", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "interpolate", "upsample",
           "unfold", "fold", "pad", "zeropad2d", "temporal_shift",
           "class_center_sample", "grid_sample", "affine_grid",
           "sequence_mask", "pairwise_distance", "gather_tree"]

_MODES = ("upscale_in_train", "downscale_in_infer")


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def keep_mask(shape, p: float, device,
              generator: Optional[random_mod.Generator] = None
              ) -> torch.Tensor:
    """A bool tensor of ``shape`` on ``device``, each element True with
    probability ``1 - p`` (the reference's ``jax.random.bernoulli(key,
    1 - p, shape)``), drawn from ``generator`` (default: the default
    generator)."""
    gen = (generator or random_mod.default_generator()).for_device(device)
    return torch.rand(tuple(shape), generator=gen, device=device) < (1.0 - p)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Zero each element of ``x`` with probability ``p`` (a mask shared
    along the dimensions not in ``axis`` when it is given). In training,
    ``upscale_in_train`` scales the kept elements by ``1 / (1 - p)`` and
    ``downscale_in_infer`` keeps them as they are; outside training (or at
    ``p == 0``) the first returns ``x`` and the second ``x * (1 - p)``, as
    the reference."""
    if has_torch_function((x,)):
        return handle_torch_function(dropout, (x,), x, p, axis, training,
                                     mode, generator=generator)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if axis is None:
        shape = x.shape
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = {a % x.dim() for a in axes}
        shape = [x.shape[i] if i in axes else 1 for i in range(x.dim())]
    keep = keep_mask(shape, p, x.device, generator)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drop whole channels of a 4-D ``x`` (one mask element per sample and
    channel)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map restores the mean and variance (the
    reference's ``:47-62``)."""
    if not training or p == 0.0:
        return x

    def fn(a):
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        keep = keep_mask(a.shape, p, a.device)
        q = 1.0 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        return a_coef * torch.where(keep, a, torch.full(
            (), alpha_p, dtype=a.dtype, device=a.device)) + b_coef
    return apply_op("alpha_dropout", fn, x)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (torch's linear
    over the weight's transposed view: no copy)."""
    if bias is not None:
        return apply_op("linear", lambda a, w, b: TF.linear(a, w.t(), b),
                        x, weight, bias)
    return apply_op("linear", lambda a, w: TF.linear(a, w.t()), x, weight)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by the ids ``x``; ids equal to ``padding_idx``
    give zeros (and no gradient), as the reference."""
    def fn(ids, w):
        out = TF.embedding(ids.long(), w)
        if padding_idx is not None:
            out = torch.where((ids == padding_idx).unsqueeze(-1),
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out
    return apply_op("embedding", fn, x, weight)


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]``; an id outside ``[0, num_classes)``
    gives a row of zeros, as ``jax.nn.one_hot``."""
    return apply_op("one_hot", lambda i: (i.unsqueeze(-1) == torch.arange(
        num_classes, device=i.device)).to(torch.float32), x)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def fn(lab, *pd):
        if pd:
            return (1 - epsilon) * lab + epsilon * pd[0]
        return (1 - epsilon) * lab + epsilon / lab.shape[-1]
    args = (label,) if prior_dist is None else (label, prior_dist)
    return apply_op("label_smooth", fn, *args)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        num = (a * b).sum(axis)
        d1 = (a * a).sum(axis).sqrt()
        d2 = (b * b).sum(axis).sqrt()
        return num / torch.clamp(d1 * d2, min=eps)
    return apply_op("cosine_similarity", fn, x1, x2)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] · weight[o] · x2[b] + bias[o]`` (weight
    ``[out, in1, in2]``)."""
    def fn(a, b, w, *mb):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + mb[0] if mb else out
    args = (x1, x2, weight) + (() if bias is None else (bias,))
    return apply_op("bilinear", fn, *args)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c // (r * r), r, r, h, w)
            return a.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r),
                                                        h * r, w * r)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, r, r, c // (r * r))
        return a.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r,
                                                   c // (r * r))
    return apply_op("pixel_shuffle", fn, x)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c, h // r, r, w // r, r)
            return a.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r,
                                                        w // r)
        n, h, w, c = a.shape
        a = a.reshape(n, h // r, r, w // r, r, c)
        return a.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r,
                                                   c * r * r)
    return apply_op("pixel_unshuffle", fn, x)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            return a.reshape(n, groups, c // groups, h, w).transpose(
                1, 2).reshape(n, c, h, w)
        n, h, w, c = a.shape
        return a.reshape(n, h, w, groups, c // groups).transpose(
            3, 4).reshape(n, h, w, c)
    return apply_op("channel_shuffle", fn, x)


_LINEAR = {"linear": 1, "bilinear": 2, "trilinear": 3}


def _src_index(out_n, in_n, align_corners, align_mode, device):
    """Paddle's source coordinate of each output position of a linear
    resize along one axis (``interpolate_kernel``): ``align_corners`` maps
    the corners onto each other, ``align_mode=0`` takes half-pixel centres
    (clamped at 0), ``align_mode=1`` scales the index."""
    d = torch.arange(out_n, device=device, dtype=torch.float32)
    if align_corners:
        ratio = (in_n - 1) / (out_n - 1) if out_n > 1 else 0.0
        return d * ratio
    ratio = in_n / out_n
    if align_mode == 0:
        return torch.clamp((d + 0.5) * ratio - 0.5, min=0.0)
    return d * ratio


def _linear_resize(a, sp_axes, out_sp, align_corners, align_mode):
    """A separable linear resize (one axis at a time): each output element
    the lerp of its two source neighbours."""
    for ax, n_out in zip(sp_axes, out_sp):
        n_in = a.shape[ax]
        src = _src_index(n_out, n_in, align_corners, align_mode, a.device)
        i0 = torch.clamp(src.floor().long(), max=n_in - 1)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        lam = (src - i0.to(src.dtype)).to(a.dtype)
        shape = [1] * a.dim()
        shape[ax] = n_out
        lam = lam.reshape(shape)
        a = a.index_select(ax, i0) * (1 - lam) + a.index_select(ax, i1) * lam
    return a


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of ``x`` to ``size`` (or the input's times
    ``scale_factor``): Paddle's "nearest" (``floor(i · in / out)``, or the
    rounded corner-aligned index with ``align_corners``), "linear",
    "bilinear", "trilinear" (half-pixel or scaled source indices by
    ``align_mode``, or corner-aligned), "bicubic" and "area" (an adaptive
    average pool). See the module docstring for where the reference
    differs."""
    channel_last = not data_format.startswith("NC")
    mode = mode.lower()

    def fn(a):
        sp_axes = list(range(1, a.dim() - 1)) if channel_last else \
            list(range(2, a.dim()))
        in_sp = [a.shape[i] for i in sp_axes]
        if size is not None:
            out_sp = [int(s) for s in (size if isinstance(size, (list, tuple))
                                       else [size] * len(in_sp))]
        else:
            sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
                else [scale_factor] * len(in_sp)
            out_sp = [int(d * float(f)) for d, f in zip(in_sp, sf)]
        if mode == "nearest":
            out = a
            for ax, din, dout in zip(sp_axes, in_sp, out_sp):
                d = torch.arange(dout, device=a.device, dtype=torch.float32)
                if align_corners and dout > 1:
                    idx = torch.floor(d * ((din - 1) / (dout - 1)) + 0.5)
                else:
                    idx = torch.floor(d * (din / dout))
                out = out.index_select(ax, idx.long().clamp(max=din - 1))
            return out
        if mode in _LINEAR:
            return _linear_resize(a, sp_axes, out_sp, align_corners,
                                  align_mode)
        xc = a.movedim(-1, 1) if channel_last else a
        if mode == "bicubic":
            y = TF.interpolate(xc, size=out_sp, mode="bicubic",
                               align_corners=bool(align_corners))
        elif mode == "area":
            pool = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
                    3: TF.adaptive_avg_pool3d}[len(out_sp)]
            y = pool(xc, out_sp)
        else:
            raise ValueError(f"interpolate: unknown mode {mode!r}")
        return y.movedim(1, -1) if channel_last else y
    return apply_op("interpolate", fn, x)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` to ``[N, C·kh·kw, L]`` (paddings an int,
    ``[ph, pw]`` or ``[top, left, bottom, right]``)."""
    k, s, d = (_tuple(v, 2) for v in (kernel_sizes, strides, dilations))
    if isinstance(paddings, (int, np.integer)):
        pads = (int(paddings),) * 4
    elif len(paddings) == 2:
        pads = (paddings[0], paddings[1], paddings[0], paddings[1])
    else:
        pads = tuple(int(p) for p in paddings)

    def fn(a):
        # [top, left, bottom, right] as torch's (left, right, top, bottom)
        a = TF.pad(a, (pads[1], pads[3], pads[0], pads[2]))
        return TF.unfold(a, k, dilation=d, padding=0, stride=s)
    return apply_op("unfold", fn, x)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of overlapping patches (the inverse layout of
    :func:`unfold`)."""
    out, k, s, d, p = (_tuple(v, 2) for v in (output_sizes, kernel_sizes,
                                               strides, dilations, paddings))
    return apply_op("fold", lambda a: TF.fold(a, out, k, dilation=d,
                                              padding=p, stride=s), x)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    from ...tensor.manipulation import pad as _tensor_pad
    return _tensor_pad(x, pad, mode, value, data_format, name)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's channel shift over segments: the first ``c · ratio`` channels
    read segment t-1, the next ``c · ratio`` segment t+1, the rest pass
    through; zeros at the segment edges (the reference's ``:233-262``)."""
    def fn(a):
        v = a.reshape((a.shape[0] // seg_num, seg_num) + tuple(a.shape[1:]))
        caxis = 2 if data_format == "NCHW" else v.dim() - 1
        c = v.shape[caxis]
        c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
        f1 = v.narrow(caxis, 0, c1)
        f2 = v.narrow(caxis, c1, c2 - c1)
        f1 = torch.cat([torch.zeros_like(f1[:, :1]), f1[:, :-1]], 1)
        f2 = torch.cat([f2[:, 1:], torch.zeros_like(f2[:, :1])], 1)
        return torch.cat([f1, f2, v.narrow(caxis, c2, c - c2)],
                         caxis).reshape(a.shape)
    return apply_op("temporal_shift", fn, x)


def class_center_sample(label, num_classes, num_samples, group=None):
    raise NotImplementedError(
        "class_center_sample: PS-style API out of scope")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Ho, Wo, 2]`` (x, y in
    [-1, 1]): Paddle's function, which is torch's ``grid_sample``."""
    return apply_op("grid_sample", lambda a, g: TF.grid_sample(
        a, g, mode=mode, padding_mode=padding_mode,
        align_corners=bool(align_corners)), x, grid)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid of the affine maps ``theta``
    ``[N, 2, 3]``."""
    def fn(th):
        n = th.shape[0]
        h, w = int(out_shape[2]), int(out_shape[3])
        return TF.affine_grid(th, [n, 1, h, w],
                              align_corners=bool(align_corners))
    return apply_op("affine_grid", fn, theta)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is below the length."""
    from ...framework.dtype import to_torch_dtype

    def fn(lengths):
        m = int(lengths.max()) if maxlen is None else int(maxlen)
        rng = torch.arange(m, device=lengths.device)
        return (rng < lengths.unsqueeze(-1)).to(to_torch_dtype(dtype))
    return apply_op("sequence_mask", fn, x)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``‖x - y + epsilon‖_p`` over the last axis."""
    def fn(a, b):
        d = a - b + epsilon
        if p == math.inf:
            return d.abs().amax(-1, keepdim=keepdim)
        if p == -math.inf:
            return d.abs().amin(-1, keepdim=keepdim)
        return (d.abs() ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)
    return apply_op("pairwise_distance", fn, x, y)


def gather_tree(ids, parents, name=None):
    """Backtrack beam search's parent pointers (``[T, B, beam]``) so that
    every step holds the ids of the full path ending in each final beam."""
    def fn(seq, par):
        beams = torch.arange(seq.shape[2], device=seq.device).expand(
            seq.shape[1:])
        toks = []
        for t in range(seq.shape[0] - 1, -1, -1):
            toks.append(torch.gather(seq[t], -1, beams))
            beams = torch.gather(par[t], -1, beams).long()
        return torch.stack(toks[::-1])
    return apply_op("gather_tree", fn, ids, parents)
