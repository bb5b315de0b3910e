"""``batch_norm``: the port of ``paddle_tpu/nn/functional/norm.py::
batch_norm`` (``:19-56``).

In training (unless ``use_global_stats``) the output is normalised by the
batch's mean and biased variance over every axis but the channel's; the
running statistics then move with Paddle's momentum, ``running = momentum
· running + (1 − momentum) · batch`` (torch's momentum is ``1 −`` Paddle's),
and the running variance takes the batch's BIASED variance, as the
reference's ``jnp.var``. torch's batch norm moves the statistics in the
same pass as the normalisation, but by the unbiased variance (``n / (n −
1)`` times the biased one, n the elements a channel): the update is then
corrected in place from the variance's value before the call, with no
second pass over the input. Outside training the running statistics
normalise. It dispatches
through ``__torch_function__``, so the port's AMP casts its inputs under the
reference's op name ``batch_norm`` (black-listed: float32 in and out at
either level, the affine parameters and statistics included).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ...core.dispatch import apply_op
from .conv import check_format, from_nchw, to_nchw

__all__ = ["batch_norm", "layer_norm"]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm of ``x`` (channel axis 1, or the last for NHWC)."""
    args = tuple(t for t in (x, running_mean, running_var, weight, bias)
                 if t is not None)
    if has_torch_function(args):
        return handle_torch_function(
            batch_norm, args, x, running_mean, running_var, weight, bias,
            training=training, momentum=momentum, epsilon=epsilon,
            data_format=data_format, use_global_stats=use_global_stats)
    nhwc = check_format(data_format)
    xc = to_nchw(x, nhwc)
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
    return from_nchw(y, nhwc)


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
