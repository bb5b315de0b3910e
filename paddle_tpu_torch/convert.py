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
- ``load_jax_optimizer_state(optimizer, model, state, step_count)`` carries
  training state across: the JAX optimizer's accumulators (AdamW's
  ``moment1``/``moment2``), keyed ``f"{parameter name}_{accumulator}"`` as
  numpy arrays in their own dtype (bfloat16 included), transposed like the
  linear weights, plus the step count.
- ``export_jax_state(model)`` is the way back: the port's parameters as
  float32 numpy arrays under the JAX names and layouts, for comparisons.
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_state", "load_jax_state",
           "load_jax_optimizer_state", "export_jax_state"]


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


def _to_torch(arr) -> torch.Tensor:
    """A writable tensor copy of a numpy array; JAX's bfloat16 (an
    ``ml_dtypes`` type numpy cannot hand to torch) goes through float32,
    which holds it exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


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
        t = _to_torch(arr)
        if name in linear and t.dim() == 2:
            t = t.t()
        dst = state[name]
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                             f"the model's {tuple(dst.shape)}")
        dst.copy_(t.to(dtype=dst.dtype))
    return model


@torch.no_grad()
def load_jax_optimizer_state(optimizer, model: nn.Module,
                             state: Dict[str, np.ndarray], step_count: int):
    """Load the JAX optimizer's accumulators into the port's ``optimizer``
    for every parameter of ``model``: ``state[f"{name}_{accumulator}"]``
    for each of ``optimizer._accum_names``, kept in its own dtype (bf16
    moments stay bf16), transposed for linear weights, on the parameter's
    device; then ``_step_count = step_count``. A missing key or a shape that
    does not match raises."""
    linear = _linear_weights(model)
    for name, p in model.named_parameters():
        for an in optimizer._accum_names:
            key = f"{name}_{an}"
            if key not in state:
                raise KeyError(f"optimizer state has no {key!r}")
            t = _to_torch(state[key])
            if name in linear and t.dim() == 2:
                t = t.t()
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} does not "
                                 f"match the parameter's {tuple(p.shape)}")
            optimizer._set_accum(an, p, t.contiguous().to(p.device))
    optimizer._bind(model.named_parameters())
    optimizer._step_count = int(step_count)
    return optimizer


@torch.no_grad()
def export_jax_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's state as float32 numpy arrays under the JAX names, the
    linear weights transposed back to ``[in, out]``."""
    linear = _linear_weights(model)
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().float().cpu()
        if name in linear and t.dim() == 2:
            t = t.t()
        out[name] = t.contiguous().numpy()
    return out
