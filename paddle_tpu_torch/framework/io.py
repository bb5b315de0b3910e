"""``save`` and ``load``: the port of ``paddle_tpu/framework/io.py``
(``paddle.save``/``paddle.load``).

The file is the reference's pickle: containers kept, every tensor replaced
by ``{"__tensor__": True, "data": ndarray, "name": str, "stop_gradient":
bool}``, so either package reads the other's files.

- Tensors are saved from the CPU (a CUDA tensor is copied back). A tensor's
  ``name`` is its key in the enclosing dict (torch tensors carry no name of
  their own); ``stop_gradient`` is ``not requires_grad``.
- numpy has no bfloat16 without ``ml_dtypes``, which the machines that run
  the port need not have. A bfloat16 tensor is therefore saved as its exact
  float32 widening with one more key, ``"dtype": "bfloat16"``: the port
  loads it back as bfloat16, bit for bit, and the reference (which ignores
  the key) as float32 of the same values.
- ``load`` returns CPU tensors (``return_numpy=True``: the arrays as
  stored). It also reads the reference's own files, whose bfloat16 arrays
  are ``ml_dtypes`` arrays (unpickling those needs ``ml_dtypes``).
- The Paddle API's ``paddle.save`` takes Paddle tensors too (named by their
  own ``name``, as the reference names them), so a ``Layer``'s or an
  optimizer's ``state_dict`` saves as it is; ``paddle.load``
  (:func:`load_paddle`) gives Paddle tensors on the current place.

Only load files this program or the reference wrote: unpickling runs code.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "load_paddle", "to_tensor"]


def to_tensor(arr) -> torch.Tensor:
    """A writable CPU tensor copy of a numpy array; an ``ml_dtypes``
    bfloat16 array (which numpy cannot hand to torch) goes through float32,
    which holds it exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _pack(obj, name=""):
    data = getattr(obj, "_data", None)
    if isinstance(data, torch.Tensor):      # a Paddle tensor
        return _pack(data, obj.name)
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        out = {"__tensor__": True, "name": name,
               "stop_gradient": not obj.requires_grad}
        if t.dtype == torch.bfloat16:
            out["data"] = t.float().numpy()
            out["dtype"] = "bfloat16"
        else:
            out["data"] = t.numpy()
        return out
    if isinstance(obj, dict):
        return {k: _pack(v, str(k)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v, f"{name}.{i}") for i, v in enumerate(obj)]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            t = to_tensor(obj["data"])
            if obj.get("dtype") == "bfloat16":
                t = t.to(torch.bfloat16)
            return t
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        un = [_unpack(v, return_numpy) for v in obj]
        return un if isinstance(obj, list) else tuple(un)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (nested dicts, lists and tuples of tensors, arrays
    and plain values) to ``path``, making its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    """Read a file :func:`save` (or the reference's ``paddle.save``) wrote:
    CPU tensors, or numpy arrays with ``return_numpy=True``."""
    return_numpy = configs.get("return_numpy", False)
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy)


def load_paddle(path, **configs):
    """``paddle.load``: :func:`load`, each tensor a Paddle tensor on
    :func:`framework.device.current_place` (``return_numpy=True``: the
    arrays as stored)."""
    from ..core.tensor import Tensor
    from .device import current_device
    obj = load(path, **configs)
    if configs.get("return_numpy", False):
        return obj
    dev = current_device()

    def conv(o):
        if isinstance(o, torch.Tensor):
            return Tensor._wrap(o.to(dev))
        if isinstance(o, dict):
            return {k: conv(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(conv(v) for v in o)
        return o
    return conv(obj)
