"""Weight bridge from the JAX package to the port.

- ``load_paddle_state(path)`` reads a ``paddle.save`` file — a pickle in
  which every tensor is a ``{"__tensor__": True, "data": ndarray, ...}``
  dict (the format of ``paddle_tpu/framework/io.py``, readable without JAX)
  — into nested dicts of numpy arrays.
- ``load_jax_state(model, arrays)`` copies a flat ``{name: ndarray}`` state
  (JAX parameter names, e.g. ``gpt.layers.0.attn.qkv_proj.weight``) into a
  port model whose ``state_dict`` keys are those same names. Paddle's
  ``Linear`` stores its weight ``[in, out]`` and torch's ``[out, in]``, so
  the 2-D weights of ``nn.Linear`` modules are transposed, and only those.
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_state", "load_jax_state"]


def _unpack(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return np.asarray(obj["data"])
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_unpack(v) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


def load_paddle_state(path) -> Dict[str, np.ndarray]:
    """Read a ``paddle.save`` file into numpy arrays (tensors unwrapped,
    containers kept)."""
    with open(path, "rb") as f:
        return _unpack(pickle.load(f))


def _linear_weights(model: nn.Module):
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


@torch.no_grad()
def load_jax_state(model: nn.Module,
                   arrays: Dict[str, np.ndarray]) -> nn.Module:
    """Copy JAX-named arrays into ``model`` (cast to each parameter's type,
    on its device). A missing or unexpected name, or a shape that does not
    match, raises."""
    state = model.state_dict()
    linear = _linear_weights(model)
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    if missing or unexpected:
        raise KeyError(f"state mismatch: missing {missing}, unexpected "
                       f"{unexpected}")
    for name, arr in arrays.items():
        t = torch.from_numpy(np.array(arr))       # a writable copy
        if name in linear and t.dim() == 2:
            t = t.t()
        dst = state[name]
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                             f"the model's {tuple(dst.shape)}")
        dst.copy_(t.to(dtype=dst.dtype))
    return model
