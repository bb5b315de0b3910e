"""Dropout (the port of ``paddle_tpu/nn/functional/common.py::dropout``).

The mask is drawn from the port's explicit generator
(``framework/random.py``): the ``torch.Generator`` of the tensor's device
inside ``generator``, or inside the default generator. ``dropout2d``,
``dropout3d`` and ``alpha_dropout`` are not ported yet (ROADMAP queue 1
item 5d, part 2).

Also ``linear`` (Paddle's ``[in, out]`` weight) and ``embedding``
(``padding_idx`` rows give zeros), the port of the reference's (``:15-20``,
``:73-80``), behind :func:`core.dispatch.apply_op`. ``dropout`` takes Paddle
tensors through ``Tensor.__torch_function__``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.overrides import handle_torch_function, has_torch_function

from ...core.dispatch import apply_op
from ...framework import random as random_mod

__all__ = ["dropout", "keep_mask", "linear", "embedding"]

_MODES = ("upscale_in_train", "downscale_in_infer")


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


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (torch's linear
    over the weight's transposed view: no copy)."""
    if bias is not None:
        return apply_op("linear", lambda a, w, b: torch.nn.functional.linear(
            a, w.t(), b), x, weight, bias)
    return apply_op("linear", lambda a, w: torch.nn.functional.linear(
        a, w.t()), x, weight)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by the ids ``x``; ids equal to ``padding_idx``
    give zeros (and no gradient), as the reference."""
    def fn(ids, w):
        out = torch.nn.functional.embedding(ids.long(), w)
        if padding_idx is not None:
            out = torch.where((ids == padding_idx).unsqueeze(-1),
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out
    return apply_op("embedding", fn, x, weight)
