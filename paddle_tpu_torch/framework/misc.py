"""Top-level odds and ends of the Paddle API: the port of
``paddle_tpu/framework/misc.py`` (``iinfo``/``finfo``, ``LazyGuard``, the
CUDA rng-state names, ``set_printoptions``, ``disable_signal_handler``, the
``batch`` reader decorator, ``check_shape`` and ``flops``)."""
from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from . import dtype as dtype_mod
from .random import get_rng_state, set_rng_state

__all__ = ["iinfo", "finfo", "LazyGuard", "get_cuda_rng_state",
           "set_cuda_rng_state", "set_printoptions", "disable_signal_handler",
           "batch", "flops", "check_shape"]


class _DTypeInfo:
    """The reference's fields of a ``torch.iinfo``/``torch.finfo``: min,
    max, bits and dtype (the type's name), and for floats eps, tiny,
    smallest_normal and resolution as Python floats (resolution rounded to
    the type, as the reference's numpy scalar holds it)."""

    def __init__(self, info, dtype):
        self._info = info
        self.min, self.max, self.bits = info.min, info.max, info.bits
        self.dtype = str(dtype)[6:]
        if hasattr(info, "eps"):
            self.eps = float(info.eps)
            self.tiny = float(info.tiny)
            self.smallest_normal = float(info.tiny)
            self.resolution = float(torch.tensor(info.resolution,
                                                 dtype=dtype))

    def __repr__(self):
        return repr(self._info)


def _torch_dtype(dtype) -> torch.dtype:
    t = dtype_mod.to_torch_dtype(dtype)
    if t is None:
        raise TypeError(f"not a dtype: {dtype!r}")
    return t


def iinfo(dtype):
    t = _torch_dtype(dtype)
    return _DTypeInfo(torch.iinfo(t), t)


def finfo(dtype):
    t = _torch_dtype(dtype)
    return _DTypeInfo(torch.finfo(t), t)


class LazyGuard:
    """Layers and models built inside the guard take their parameters on
    the ``meta`` device: shapes and dtypes, no memory and no random draws
    (the reference gives them abstract arrays for the same purpose:
    planning a model too large to allocate). Build the model again outside
    the guard, or ``to_empty`` it on a device, to give it weights."""

    def __enter__(self):
        device_mod._lazy_depth += 1
        return self

    def __exit__(self, *exc):
        device_mod._lazy_depth -= 1
        return False


def get_cuda_rng_state():
    """The reference's one-element list over the generator's state (the
    port's generator holds every device's stream)."""
    return [get_rng_state()]


def set_cuda_rng_state(state_list):
    if state_list:
        set_rng_state(state_list[0])


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print: numpy's print options, which ``Tensor.__repr__``
    prints through, and torch's."""
    kwargs = {}
    if precision is not None:
        kwargs["precision"] = precision
    if threshold is not None:
        kwargs["threshold"] = threshold
    if edgeitems is not None:
        kwargs["edgeitems"] = edgeitems
    if linewidth is not None:
        kwargs["linewidth"] = linewidth
    np.set_printoptions(**kwargs, **(
        {} if sci_mode is None else {"suppress": not sci_mode}))
    torch.set_printoptions(**kwargs, sci_mode=sci_mode)


def disable_signal_handler():
    """Nothing to do: the reference unhooks its C++ signal handlers, and
    the port installs none."""


def batch(reader, batch_size, drop_last=False):
    """The legacy reader decorator (``python/paddle/batch.py``): a generator
    of samples becomes a generator of lists of ``batch_size`` samples."""
    if not isinstance(batch_size, (int, np.integer)) or batch_size <= 0:
        raise ValueError("batch_size should be a positive integer value, "
                         f"but got {batch_size!r}")

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def check_shape(shape):
    """Check a shape argument: each element an int, -1 or None."""
    if isinstance(shape, (list, tuple)):
        for s in shape:
            if s is not None and not isinstance(s, (int, np.integer)) \
                    and s != -1:
                raise TypeError(f"invalid shape element {s!r}")
    return shape


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The forward FLOPs of ``net`` on zeros of ``input_size`` (float32),
    counted as the reference counts them: 2 a multiply-add in every
    ``Linear`` and ``Conv2D`` (forward post-hooks on a dry run in eval
    mode), and what ``custom_ops[type](layer, inputs, output)`` hooks add
    for other layer types."""
    from ..core.tensor import to_tensor
    from ..nn import Conv2D, Linear

    totals = {"flops": 0}
    rows = []

    def conv_hook(layer, inputs, output):
        x = inputs[0]
        kh, kw = layer.kernel_size
        cout = output.shape[1]
        hw = int(np.prod(output.shape[2:]))
        fl = 2 * cout * hw * layer.weight.shape[1] * kh * kw * x.shape[0]
        totals["flops"] += fl
        rows.append((type(layer).__name__, fl))

    def linear_hook(layer, inputs, output):
        n = int(np.prod(inputs[0].shape[:-1]))
        fl = 2 * n * layer.weight.shape[0] * layer.weight.shape[1]
        totals["flops"] += fl
        rows.append((type(layer).__name__, fl))

    custom_ops = custom_ops or {}
    hooks = []
    for m in net.sublayers():
        if type(m) in custom_ops:
            hooks.append(m.register_forward_post_hook(custom_ops[type(m)]))
        elif isinstance(m, Conv2D):
            hooks.append(m.register_forward_post_hook(conv_hook))
        elif isinstance(m, Linear):
            hooks.append(m.register_forward_post_hook(linear_hook))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(to_tensor(np.zeros(input_size, dtype=np.float32)))
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()
    if print_detail:
        for name, fl in rows:
            print(f"{name:>16}: {fl:,}")
    return totals["flops"]
