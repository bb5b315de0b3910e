"""The Paddle tensor of the port: a Paddle-shaped handle over a
``torch.Tensor``.

The counterpart of ``paddle_tpu/core/tensor.py``. As there, the tensor is a
wrapper: :class:`Tensor` holds its value in ``_data`` (a ``torch.Tensor``)
and is *not* a ``torch.Tensor`` subclass. The reason is that Paddle's tensor
methods clash with torch's under the same names: ``size`` is a property (the
element count) in Paddle and a method in torch, ``shape`` a list against a
``torch.Size``, ``transpose`` takes a permutation, ``max``/``min``/``sort``
give values only, reductions take ``axis=``, ``gather`` is an index select,
``split`` takes ``num_or_sections``, ``flatten`` takes ``start_axis``/
``stop_axis``, and ``stop_gradient`` is the opposite of ``requires_grad``.
torch's own Python code (``torch.nn.functional``, the optimizers,
``torch.export``) calls ``x.size(0)``, ``x.sort()`` and ``x.transpose(0, 1)``
on the tensors it receives; a subclass that gave those names Paddle's meaning
would break it.

- Autograd is torch's: there is no tape here. ``stop_gradient=False`` is
  ``_data.requires_grad_()``; ``backward``, ``grad`` and the hooks map onto
  ``torch.autograd`` (``core/autograd.py``), and ``.grad`` wraps
  ``_data.grad``.
- :meth:`Tensor.__torch_function__` unwraps its arguments, calls the torch
  function and wraps what it returns, so every torch function and
  ``nn.Module`` of the port accepts Paddle tensors. The type of the data
  decides the type out (``core/dispatch.py::unwrap_tree``): a torch tensor
  in gives a torch tensor out, even through a layer's Paddle parameters,
  which are *state* (``_state``) and do not decide.
- A tensor is made on :func:`framework.device.current_place` unless a
  ``place`` is given: ``cuda`` by default, the CPU after
  ``paddle.set_device("cpu")``; without a GPU and without that request,
  making one raises.

The op surface (``paddle_tpu_torch.tensor``) is patched onto the class at
import, as the reference patches it.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.device import current_device, place_to_device
from ..framework.place import Place, place_of

__all__ = ["Tensor", "Parameter", "to_tensor"]

_tensor_ids = itertools.count(1)
_param_ids = itertools.count(0)


def _as_torch(data, dtype, device) -> torch.Tensor:
    """A new torch tensor from Python or numpy data: Python floats and
    float64 data that is not a float64 numpy array take the default float
    dtype, as the reference (``core/tensor.py:52-57``)."""
    if isinstance(data, (list, tuple)) and any(isinstance(x, Tensor)
                                               for x in data):
        data = [x.numpy() if isinstance(x, Tensor) else x for x in data]
    arr = np.asarray(data)
    tdt = dtype_mod.to_torch_dtype(dtype)
    if tdt is None and arr.dtype == np.float64 and \
            not isinstance(data, np.ndarray):
        tdt = dtype_mod.default_float_dtype().torch_dtype
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=tdt)


class Tensor:
    """A Paddle tensor over ``torch.Tensor`` (see the module docstring)."""

    __slots__ = ("_data", "_leaf", "_name", "_state", "__weakref__",
                 "__dict__")
    persistable = False

    def __init__(self, data, dtype=None, place: Optional[Place] = None,
                 stop_gradient: bool = True, name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._data
        if isinstance(data, torch.Tensor):
            t = data
            if dtype is not None or place is not None:
                t = t.to(device=None if place is None
                         else place_to_device(place),
                         dtype=dtype_mod.to_torch_dtype(dtype))
        else:
            t = _as_torch(data, dtype, place_to_device(place)
                          if place is not None else current_device())
        self._data = t
        self._leaf = None
        self._name = name
        self._state = False
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, t: torch.Tensor) -> "Tensor":
        """Wrap a torch tensor without copying or checking (the ops'
        results)."""
        obj = object.__new__(Tensor)
        obj._data = t
        obj._leaf = None
        obj._name = None
        obj._state = False
        return obj

    # ---------------- torch interop ----------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        from .dispatch import unwrap_tree, wrap_tree
        (args, kwargs), paddle_out = unwrap_tree((args, kwargs or {}))
        out = func(*args, **kwargs)
        return wrap_tree(out) if paddle_out else out

    # ---------------- basic properties ----------------
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = f"generated_tensor_{next(_tensor_ids)}"
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    def numel(self) -> int:
        return self._data.numel()

    @property
    def dtype(self) -> dtype_mod.DType:
        return dtype_mod.convert_dtype(self._data.dtype)

    @property
    def place(self) -> Place:
        return place_of(self._data.device)

    @property
    def T(self):
        from ..tensor import linalg
        return linalg.transpose_last2(self) if self.ndim >= 2 else self

    @property
    def is_leaf(self) -> bool:
        return self._data.is_leaf

    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        t = self._data
        if value:
            if t.requires_grad:
                if t.is_leaf:
                    t.requires_grad_(False)
                else:           # cut the graph here, as Paddle does
                    self._data = t.detach()
        elif not t.requires_grad and (t.is_floating_point()
                                      or t.is_complex()):
            if t.is_leaf:
                t.requires_grad_(True)
            else:
                self._data = t.detach().requires_grad_(True)

    # ---------------- gradients ----------------
    def _grad_holder(self) -> torch.Tensor:
        # an in-place op rebinds a leaf that requires grad to its result
        # (as the reference's _inplace does); the leaf keeps receiving the
        # gradient, as the reference's edge snapshot does
        return self._leaf if self._leaf is not None else self._data

    @property
    def grad(self):
        g = self._grad_holder().grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        self._grad_holder().grad = None if value is None else (
            value._data if isinstance(value, Tensor) else value)

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def backward(self, grad_tensor=None, retain_graph=False):
        from . import autograd
        autograd.backward([self], None if grad_tensor is None
                          else [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._grad_holder().grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """Call ``hook(grad)`` on each gradient that reaches this tensor;
        a Tensor it returns replaces the gradient. Returns a handle with
        ``remove()``."""
        def torch_hook(g):
            out = hook(Tensor._wrap(g))
            return out._data if isinstance(out, Tensor) else out
        return self._grad_holder().register_hook(torch_hook)

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._data.detach())

    def detach_(self) -> "Tensor":
        self._data = self._data.detach()
        self._leaf = None
        return self

    def clone(self) -> "Tensor":
        from .dispatch import apply_op
        return apply_op("clone", torch.clone, self)

    # ---------------- conversion ----------------
    def numpy(self) -> np.ndarray:
        """A numpy copy of the values (from the card if they are there);
        bfloat16 comes back as float32, which holds it exactly."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.numpy(force=True))

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        return int(self.item())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of a Tensor with more than one "
                             "element is ambiguous.")
        return bool(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        grad_s = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_s},\n       {self.numpy()})")

    # ---------------- placement ----------------
    def _moved(self, device=None, dtype=None) -> "Tensor":
        from .dispatch import apply_op
        return apply_op("to", lambda a: a.to(device=device, dtype=dtype),
                        self)

    def cpu(self) -> "Tensor":
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True) -> "Tensor":
        return self._moved(torch.device(
            "cuda", device_id if device_id is not None
            else torch.cuda.current_device()))

    def to(self, *args, **kwargs) -> "Tensor":
        """``to(device)``, ``to(dtype)`` or both (places, "cpu"/"gpu:i",
        ``torch.device``; Paddle or torch dtypes)."""
        device, dtype = kwargs.get("device"), kwargs.get("dtype")
        for a in args:
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0].lower() in (
                        "cpu", "gpu", "cuda", "tpu", "xpu", "npu")):
                device = a
            elif a is not None and not isinstance(a, bool):
                dtype = a
        return self._moved(None if device is None
                           else place_to_device(device),
                           dtype_mod.to_torch_dtype(dtype))

    def pin_memory(self) -> "Tensor":
        return Tensor._wrap(self._data.pin_memory())

    # ---------------- mutation ----------------
    @torch.no_grad()
    def set_value(self, value) -> "Tensor":
        """Write ``value`` into this tensor in place (a parameter stays the
        object its layer and optimizer hold)."""
        if isinstance(value, Tensor):
            src = value._data
        elif isinstance(value, torch.Tensor):
            src = value
        else:
            src = _as_torch(value, None, torch.device("cpu"))
        self._data.copy_(src.reshape(self._data.shape))
        return self

    def copy_(self, other, *args):
        return self.set_value(other)

    @torch.no_grad()
    def fill_(self, value) -> "Tensor":
        self._data.fill_(value)
        return self

    def zero_(self) -> "Tensor":
        return self.fill_(0)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: a new tensor (a copy) of ``data`` on ``place``
    (default: :func:`framework.device.current_place`)."""
    if isinstance(data, Tensor):
        data = data._data
    if isinstance(data, torch.Tensor):
        t = data.detach().to(
            device=place_to_device(place) if place is not None
            else current_device(), dtype=dtype_mod.to_torch_dtype(dtype),
            copy=True)
        return Tensor(t, stop_gradient=stop_gradient)
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)


class Parameter(Tensor):
    """A trainable leaf (the reference's ``Parameter``): ``_data`` is a
    ``torch.nn.Parameter``, which a :class:`nn.Layer` registers with torch,
    and which carries this object back in its ``_paddle`` attribute.
    Parameters are layer state: they do not decide whether a torch function
    returns Paddle tensors."""

    def __init__(self, data, dtype=None, name=None, trainable=True):
        if isinstance(data, Tensor):
            data = data._data
        t = data if isinstance(data, torch.Tensor) else \
            _as_torch(data, dtype, current_device())
        if dtype is not None:
            t = t.to(dtype_mod.to_torch_dtype(dtype))
        floating = t.is_floating_point() or t.is_complex()
        self._adopt(torch.nn.Parameter(t.detach(),
                                       requires_grad=trainable and floating),
                    name)

    def _adopt(self, p: torch.nn.Parameter, name=None) -> None:
        self._data = p
        p._paddle = self
        self._leaf = None
        self._name = name or f"param_{next(_param_ids)}"
        self._state = True
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_bias = False

    @classmethod
    def of(cls, p: torch.nn.Parameter) -> "Parameter":
        """The Paddle handle of a torch parameter (made once)."""
        obj = getattr(p, "_paddle", None)
        if obj is None:
            obj = object.__new__(cls)
            obj._adopt(p)
        return obj

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value: bool):
        self.stop_gradient = not value

    @property
    def need_clip(self) -> bool:
        # kept on the torch parameter, where the grad clips read it
        return getattr(self._data, "need_clip", True)

    @need_clip.setter
    def need_clip(self, value: bool):
        self._data.need_clip = bool(value)

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()
