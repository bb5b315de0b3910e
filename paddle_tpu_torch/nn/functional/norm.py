"""Normalisations: the port of ``paddle_tpu/nn/functional/norm.py``.

``batch_norm`` (``:19-56``): in training (unless ``use_global_stats``) the
output is normalised by the batch's mean and biased variance over every
axis but the channel's (axis 1, or the last for a channels-last format);
the running statistics then move with Paddle's momentum, ``running =
momentum · running + (1 − momentum) · batch`` (torch's momentum is ``1 −``
Paddle's), and the running variance takes the batch's BIASED variance, as
the reference's ``jnp.var``. torch's batch norm moves the statistics in the
same pass as the normalisation, but by the unbiased variance (``n / (n −
1)`` times the biased one, n the elements a channel): the update is then
corrected in place from the variance's value before the call, with no
second pass over the input. Outside training the running statistics
normalise. It dispatches through ``__torch_function__``, so the port's AMP
casts its inputs under the reference's op name ``batch_norm``
(black-listed: float32 in and out at either level, the affine parameters
and statistics included).

``layer_norm``, ``instance_norm`` (over the spatial axes of each sample
and channel), ``group_norm``, ``normalize`` (by the p-norm along an axis),
``local_response_norm`` (over a window of channels) and ``spectral_norm``
(the weight over its largest singular value, by power iteration from a
vector of ones, differentiated through, as the reference's) run behind
:func:`core.dispatch.apply_op` under the reference's names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ...core.dispatch import apply_op
from .conv import check_format, from_nchw, to_nchw

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "normalize", "local_response_norm", "spectral_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm of ``x`` (channel axis 1, or the last for a
    channels-last format)."""
    args = tuple(t for t in (x, running_mean, running_var, weight, bias)
                 if t is not None)
    if has_torch_function(args):
        return handle_torch_function(
            batch_norm, args, x, running_mean, running_var, weight, bias,
            training=training, momentum=momentum, epsilon=epsilon,
            data_format=data_format, use_global_stats=use_global_stats)
    last = check_format(data_format)
    xc = to_nchw(x, last)
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if use_stats:
        y = F.batch_norm(xc, running_mean, running_var, weight, bias,
                         training=False, eps=epsilon)
    elif not training:
        y = F.batch_norm(xc, None, None, weight, bias, training=True,
                         eps=epsilon)
    else:
        # torch moves a copy of the variance (autograd keeps what it was
        # handed, so the buffer itself is written once, below)
        moved = running_var.detach().clone()
        y = F.batch_norm(xc, running_mean, moved, weight, bias,
                         training=True, momentum=1.0 - momentum, eps=epsilon)
        n = xc.numel() // xc.shape[1]
        with torch.no_grad():
            # (1 - momentum) · unbiased → (1 - momentum) · biased
            kept = momentum * running_var
            running_var.copy_(kept + (moved - kept) * ((n - 1) / n))
    return from_nchw(y, last)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """Normalise over the trailing ``normalized_shape`` axes by the mean and
    biased variance (``paddle_tpu/nn/functional/norm.py:70-100``), then the
    affine ``weight`` and ``bias``; behind :func:`core.dispatch.apply_op`
    under the reference's name ``layer_norm`` (black-listed by AMP)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = [int(s) for s in normalized_shape]

    def fn(a, w, b):
        return F.layer_norm(a, shape, None if w is None else w.reshape(shape),
                            None if b is None else b.reshape(shape), epsilon)
    return apply_op("layer_norm", fn, x, weight, bias)


def _affine(out, wb, shape):
    w, b = wb
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each sample's channel normalised over its spatial axes (the
    statistics arguments are accepted and unused, as the reference's)."""
    last = check_format(data_format)

    def fn(a, w, b):
        axes = tuple(range(1, a.dim() - 1)) if last else \
            tuple(range(2, a.dim()))
        m = a.mean(axes, keepdim=True)
        v = a.var(axes, unbiased=False, keepdim=True)
        shape = [1] * a.dim()
        shape[-1 if last else 1] = a.shape[-1 if last else 1]
        return _affine((a - m) * torch.rsqrt(v + eps), (w, b), shape)
    return apply_op("instance_norm", fn, x, weight, bias)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    last = check_format(data_format)

    def fn(a, w, b):
        at = to_nchw(a, last)
        n, c = at.shape[:2]
        g = at.reshape((n, num_groups, c // num_groups) + at.shape[2:])
        axes = tuple(range(2, g.dim()))
        m = g.mean(axes, keepdim=True)
        v = g.var(axes, unbiased=False, keepdim=True)
        out = ((g - m) * torch.rsqrt(v + epsilon)).reshape(at.shape)
        out = _affine(out, (w, b), [1, c] + [1] * (at.dim() - 2))
        return from_nchw(out, last)
    return apply_op("group_norm", fn, x, weight, bias)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(‖x‖_p, epsilon)`` along ``axis``."""
    def fn(a):
        nrm = (a.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)
    return apply_op("normalize", fn, x)


def local_response_norm(x, size, alpha=0.0001, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha · Σ x²)^beta``, the sum over ``size`` channels
    around each (``size // 2`` before, the rest after)."""
    def fn(a):
        ch = 1 if data_format.startswith("NC") else a.dim() - 1
        half = size // 2
        sq = (a * a).movedim(ch, -1)
        ssum = F.pad(sq, (half, size - half - 1)).unfold(-1, size, 1).sum(-1)
        return a / torch.pow(k + alpha * ssum.movedim(-1, ch), beta)
    return apply_op("local_response_norm", fn, x)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight / σ``, σ the largest singular value of ``weight`` viewed
    ``[shape[dim], -1]``, from ``power_iters`` power iterations starting at
    a vector of ones (σ the Frobenius norm at 0 iterations)."""
    def fn(w):
        w_mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
        u = torch.ones(w_mat.shape[0], dtype=w.dtype, device=w.device)
        v = None
        for _ in range(power_iters):
            v = w_mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = w_mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        sigma = u @ w_mat @ v if v is not None else \
            torch.linalg.vector_norm(w_mat)
        return w / sigma
    return apply_op("spectral_norm", fn, weight)
