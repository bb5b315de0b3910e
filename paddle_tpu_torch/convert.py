"""Weight bridge from the JAX package to the port.

- ``load_paddle_state(path)`` reads a ``paddle.save`` file — a pickle in
  which every tensor is a ``{"__tensor__": True, "data": ndarray, ...}``
  dict (the format of ``paddle_tpu/framework/io.py``, readable without JAX)
  — into nested dicts of numpy arrays.
- ``load_jax_state(model, arrays)`` copies a flat ``{name: ndarray}`` state
  (JAX parameter names, e.g. ``gpt.layers.0.attn.qkv_proj.weight``) into a
  port model whose ``state_dict`` keys are those same names. Paddle's
  ``Linear`` stores its weight ``[in, out]`` and torch's ``[out, in]``, so
  the 2-D weights of ``nn.Linear`` modules are transposed, and only those:
  the reference's Linear, ColumnParallelLinear and RowParallelLinear (GPT,
  BERT, ERNIE, ResNet's classifier) are ``nn.Linear`` in the port; its
  VocabParallelEmbedding (an ``nn.Embedding``), the raw position,
  token-type and task-type tables and the convolutions' OIHW weights keep
  their layout. Buffers are part of ``state_dict``: BatchNorm's ``_mean``
  and ``_variance`` cross under the reference's names.
- ``load_jax_optimizer_state(optimizer, model, state, step_count)`` carries
  training state across: the JAX optimizer's accumulators (AdamW's
  ``moment1``/``moment2``), keyed ``f"{parameter name}_{accumulator}"`` as
  numpy arrays in their own dtype (bfloat16 included), transposed like the
  linear weights, plus the step count.
- ``export_jax_state(model)`` is the way back: the port's parameters as
  float32 numpy arrays under the JAX names and layouts, for comparisons.
- ``stack_layer_state(state)`` turns a per-layer GPT state (the module
  stack's ``gpt.layers.{i}.*`` names, torch layouts) into the stacked
  decoder's (``gpt.decoder.qkv_w [L, in, out]``, ...), so one set of weights
  runs through both decoders.
- ``load_paddle_training_state(model, optimizer, model_file, opt_file,
  scaler=, scaler_file=)`` resumes from the reference's training checkpoint
  (``paddle.save`` of the model's and the optimizer's ``state_dict()``, and
  of a ``GradScaler``'s): weights, accumulators, ``LR_Scheduler`` and
  ``@step`` (so Adam's t continues), and the scaler's state. The
  reference's optimizer keys its accumulators by each parameter's unique
  name (``p.name``, ``paddle_tpu/optimizer/optimizer.py:208-233``), the
  port by its ``named_parameters()`` name; the model file holds both (each
  tensor's ``name`` under its structured key), which maps one to the
  other.

The stacked decoder's parameters (``gpt.decoder.qkv_w`` and the rest) are
not ``nn.Linear`` weights: they keep the reference's ``[L, in, out]``
layout and cross all three functions untransposed, their AdamW moments
too.
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch
from torch import nn

from .framework.io import to_tensor as _to_torch

__all__ = ["load_paddle_state", "load_jax_state",
           "load_jax_optimizer_state", "export_jax_state",
           "stack_layer_state", "load_paddle_training_state"]

# the stacked decoder's parameter ← the module stack's, per layer; True
# where the module stack holds an nn.Linear weight ([out, in])
_STACKED_FROM_LAYER = {
    "ln1_w": ("ln_1.weight", False), "ln1_b": ("ln_1.bias", False),
    "qkv_w": ("attn.qkv_proj.weight", True),
    "qkv_b": ("attn.qkv_proj.bias", False),
    "out_w": ("attn.out_proj.weight", True),
    "out_b": ("attn.out_proj.bias", False),
    "ln2_w": ("ln_2.weight", False), "ln2_b": ("ln_2.bias", False),
    "fc1_w": ("mlp.fc_in.weight", True), "fc1_b": ("mlp.fc_in.bias", False),
    "fc2_w": ("mlp.fc_out.weight", True),
    "fc2_b": ("mlp.fc_out.bias", False),
}


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
        p = getattr(p, "_data", p)     # a Paddle Layer's torch tensor
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
    # (a Paddle Layer's parameters keep their own names)
    optimizer._bind((n, p) for n, p in model.named_parameters()
                    if not hasattr(p, "_data"))
    optimizer._step_count = int(step_count)
    return optimizer


@torch.no_grad()
def export_jax_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's state as float32 numpy arrays under the JAX names, the
    linear weights transposed back to ``[in, out]``: copies, which later
    updates of the model leave as they are."""
    linear = _linear_weights(model)
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().float().cpu()
        if name in linear and t.dim() == 2:
            t = t.t()
        out[name] = t.contiguous().numpy().copy()
    return out


@torch.no_grad()
def stack_layer_state(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The stacked decoder's state from a per-layer one (tensors in the
    port's layouts, e.g. ``model.state_dict()`` or a dict of gradients
    under the same names): the ``gpt.layers.{i}.*`` entries stacked along
    a new leading layer axis as ``gpt.decoder.*`` (linear weights
    transposed to ``[in, out]``), every other entry as it is."""
    n_layers = 1 + max((int(k.split(".")[2]) for k in state
                        if k.startswith("gpt.layers.")), default=-1)
    out = {k: v for k, v in state.items()
           if not k.startswith("gpt.layers.")}
    for name, (suffix, linear) in _STACKED_FROM_LAYER.items():
        ts = [state[f"gpt.layers.{i}.{suffix}"] for i in range(n_layers)]
        out[f"gpt.decoder.{name}"] = torch.stack(
            [t.t() if linear else t for t in ts])
    return out


def _read_raw(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@torch.no_grad()
def load_paddle_training_state(model: nn.Module, optimizer, model_file,
                               opt_file, scaler=None, scaler_file=None):
    """Resume the port's ``model``, ``optimizer`` (and ``scaler``) from the
    reference's training checkpoint: ``model_file`` from
    ``paddle.save(model.state_dict())``, ``opt_file`` from
    ``paddle.save(opt.state_dict())`` (accumulators under
    ``f"{p.name}_{accumulator}"``, ``LR_Scheduler``, ``@step``) and
    ``scaler_file`` from ``paddle.save(scaler.state_dict())``. Weights go
    through :func:`load_jax_state`, accumulators through
    :func:`load_jax_optimizer_state` once renamed to the structured names;
    the scheduler's state into the optimizer's ``LRScheduler``."""
    raw = _read_raw(model_file)
    by_pname = {v["name"]: k for k, v in raw.items()
                if isinstance(v, dict) and v.get("__tensor__")}
    load_jax_state(model, _unpack(raw))
    opt = _unpack(_read_raw(opt_file))
    state = {}
    for key, value in opt.items():
        for an in optimizer._accum_names:
            suffix = f"_{an}"
            if key.endswith(suffix) and key[:-len(suffix)] in by_pname:
                state[f"{by_pname[key[:-len(suffix)]]}{suffix}"] = value
    load_jax_optimizer_state(optimizer, model, state,
                             step_count=int(opt.get("@step", 0)))
    if "LR_Scheduler" in opt and hasattr(optimizer._lr, "set_state_dict"):
        optimizer._lr.set_state_dict(opt["LR_Scheduler"])
    if scaler is not None and scaler_file is not None:
        scaler.load_state_dict(_unpack(_read_raw(scaler_file)))
    return model, optimizer
