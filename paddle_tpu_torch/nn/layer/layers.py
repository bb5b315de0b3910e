"""``nn.Layer``: the port of ``paddle_tpu/nn/layer/layers.py``.

``Layer`` subclasses ``torch.nn.Module``, so a Layer nests in a torch model
and a torch module in a Layer. Its parameters are registered with torch:
``_parameters`` holds ``torch.nn.Parameter`` objects, each carrying its
Paddle :class:`core.tensor.Parameter` (``_paddle``), which attribute access
returns. Buffers likewise (``register_buffer`` keeps the torch tensor, and
attribute access gives the Paddle tensor over it). Torch's own code (the
port's optimizers, ``torch.export``, ``nn.Module.state_dict(self)``) sees
torch tensors through ``_parameters`` and ``_buffers``.

Where Paddle's names clash with ``nn.Module``'s, Paddle's meaning wins on a
Layer: ``parameters()`` and ``named_parameters()`` give Paddle Parameters,
``state_dict()`` the reference's structured names over Paddle tensors,
``to()`` takes Paddle's places and dtypes, ``train()``/``eval()`` take no
mode. Each still answers torch's calling convention where torch calls it on
a child (``state_dict(destination=, prefix=, keep_vars=)``,
``train(mode)``), so a Layer inside a torch model behaves as a module.
Paddle's forward pre- and post-hooks are torch's forward pre-hooks and
forward hooks, which have the same contract.
"""
from __future__ import annotations

import collections
from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ...core.tensor import Parameter, Tensor
from ...framework import dtype as dtype_mod
from ...framework.device import place_to_device

__all__ = ["Layer"]


def _paddle_of(t):
    """The Paddle tensor over a registered torch tensor."""
    if t is None:
        return None
    obj = getattr(t, "_paddle", None)
    if obj is None:
        if isinstance(t, nn.Parameter):
            return Parameter.of(t)
        obj = Tensor._wrap(t)
        obj._state = True
        obj.persistable = True
        t._paddle = obj
    return obj


class Layer(nn.Module):
    """A Paddle layer (see the module docstring)."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()
        self._non_persistable_buffer_names = set()

    # ---------------- registration ----------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__.pop(name, None)
            self._parameters[name] = value._data
            return
        if isinstance(value, Tensor) and name in self.__dict__.get(
                "_buffers", ()):
            value._state = True
            value._data._paddle = value
            self._buffers[name] = value._data
            return
        if value is None and name in self.__dict__.get("_parameters", ()):
            self._parameters[name] = None
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        d = self.__dict__
        params = d.get("_parameters")
        if params is not None and name in params:
            return _paddle_of(params[name])
        bufs = d.get("_buffers")
        if bufs is not None and name in bufs:
            return _paddle_of(bufs[name])
        return super().__getattr__(name)

    def add_parameter(self, name: str, parameter):
        self._parameters[name] = None if parameter is None \
            else parameter._data
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        """Register ``tensor`` (a Paddle or torch tensor, or None) as a
        buffer; a non-persistable one stays out of ``state_dict``."""
        t = tensor._data if isinstance(tensor, Tensor) else tensor
        super().register_buffer(name, t, persistent=persistable)
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        if isinstance(tensor, Tensor):
            tensor._state = True
            t._paddle = tensor
            tensor.persistable = persistable
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..initializer_utils import create_parameter_with_attr
        return create_parameter_with_attr(
            shape, dtype or self._dtype, attr, is_bias, default_initializer)

    # ---------------- traversal ----------------
    def named_parameters(self, prefix="", include_sublayers=True,
                         **torch_kwargs) -> Iterator[Tuple[str, Parameter]]:
        """``(structured name, Parameter)`` pairs, each parameter once
        (torch's pairs when called with torch's keywords)."""
        if torch_kwargs:
            yield from nn.Module.named_parameters(self, prefix=prefix,
                                                  **torch_kwargs)
            return
        for name, p in nn.Module.named_parameters(
                self, prefix=prefix, recurse=include_sublayers):
            yield name, Parameter.of(p)

    def parameters(self, include_sublayers=True, **torch_kwargs):
        if torch_kwargs:
            return nn.Module.parameters(self, **torch_kwargs)
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      **torch_kwargs):
        if torch_kwargs:
            yield from nn.Module.named_buffers(self, prefix=prefix,
                                               **torch_kwargs)
            return
        for name, b in nn.Module.named_buffers(self, prefix=prefix,
                                               recurse=include_sublayers):
            yield name, _paddle_of(b)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def full_name(self):
        return self._name_scope

    # ---------------- modes ----------------
    def train(self, mode: bool = True):
        return nn.Module.train(self, mode)

    def eval(self):
        return nn.Module.train(self, False)

    # ---------------- hooks ----------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; what it returns (not None)
        replaces the outputs."""
        return self.register_forward_hook(hook)

    # ---------------- state dict ----------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kwargs):
        """The persistable parameters and buffers by structured name, as
        Paddle tensors (torch's ``state_dict(prefix=, keep_vars=)``, as a
        torch parent calls it, gives torch's)."""
        if torch_kwargs or not isinstance(include_sublayers, bool):
            return nn.Module.state_dict(self, destination=destination,
                                        **torch_kwargs)
        dest = destination if destination is not None \
            else collections.OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(prefix, include_sublayers):
            dest[name] = p
        for name, mod in self.named_modules(prefix=prefix) \
                if include_sublayers else [(prefix, self)]:
            skip = getattr(mod, "_non_persistable_buffer_names", set()) | \
                getattr(mod, "_non_persistent_buffers_set", set())
            for bname, b in mod._buffers.items():
                if b is not None and bname not in skip:
                    dest[f"{name}.{bname}" if name else bname] = \
                        _paddle_of(b)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (Paddle or torch tensors, numpy
        arrays) into this layer's in place; returns ``(missing,
        unexpected)`` names."""
        own = self.state_dict()
        missing, unexpected = [], []
        for name, target in own.items():
            if name in state_dict:
                value = state_dict[name]
                if isinstance(value, Tensor):
                    value = value._data
                elif not isinstance(value, torch.Tensor):
                    value = np.asarray(value)
                target.set_value(value)
            else:
                missing.append(name)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---------------- dtype and placement ----------------
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)``: places, "cpu" and
        "gpu:i" strings or ``torch.device``; Paddle or torch dtypes (floating
        parameters and buffers are cast)."""
        device, dtype = kwargs.pop("device", None), kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.dtype) or isinstance(
                    a, dtype_mod.DType) or (isinstance(a, str) and a in (
                        "float16", "bfloat16", "float32", "float64")):
                dtype = a
            elif a is not None and not isinstance(a, bool):
                device = a
        if device is not None:
            nn.Module.to(self, device=place_to_device(device))
        if dtype is not None:
            self._convert_dtype(dtype)
        return self

    def _convert_dtype(self, dtype):
        tdt = dtype_mod.to_torch_dtype(dtype)
        if not tdt.is_floating_point:
            raise TypeError(f"Layer.astype takes a floating dtype, got "
                            f"{dtype}")
        nn.Module.to(self, dtype=tdt)

    def astype(self, dtype):
        self._convert_dtype(dtype)
        return self

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def extra_repr(self):
        return ""
