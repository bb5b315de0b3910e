"""Tensor-parallel (Megatron) layers: the port of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``.

As in the reference (``mp_layers.py:1-13``) the layers hold logically full
parameters marked with their spec (``dist_spec``, Paddle layout: a weight
``[in, out]``): a column-parallel weight ``(None, "mp")`` and its bias
``("mp",)``, a row-parallel weight ``("mp", None)``, a vocab-parallel table
``("mp", None)``. On one slot they compute exactly what the plain layers
compute. Under a live global mesh with an ``mp`` axis they run once per
slot on that slot's block of the full parameter, and the collectives GSPMD
would insert are explicit: a column layer concatenates its slots' outputs
(``gather_output``), a row layer sums its slots' partial products in slot
order, the vocab table sums its slots' masked lookups.

``mark_megatron`` writes the same marks on a model built from plain
``nn.Linear``/``nn.Embedding`` modules, by the reference's module names
(``word_embeddings``, ``qkv_proj``/``fc_in`` column, ``out_proj``/``fc_out``
row): the port's GPT, BERT and ERNIE call it, so their spec trees are the
reference's.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ...mesh_utils import get_global_mesh, reduce_in_slot_order
from ...shard import mark_param

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mark_megatron",
           "get_rng_state_tracker"]

_COLUMN = ("qkv_proj", "fc_in")
_ROW = ("out_proj", "fc_out")


def mark_megatron(module: nn.Module) -> nn.Module:
    """Mark a model's projections and vocab table as the reference's TP
    layers mark theirs at construction."""
    for name, mod in module.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, nn.Linear) and leaf in _COLUMN:
            mark_param(mod.weight, (None, "mp"))
            if mod.bias is not None:
                mark_param(mod.bias, ("mp",))
        elif isinstance(mod, nn.Linear) and leaf in _ROW:
            mark_param(mod.weight, ("mp", None))
            if mod.bias is not None:
                mark_param(mod.bias, (None,))
        elif isinstance(mod, nn.Embedding) and leaf == "word_embeddings":
            mark_param(mod.weight, ("mp", None))
    return module


def _mp() -> int:
    mesh = get_global_mesh()
    if mesh is None or "mp" not in mesh.axis_names:
        return 1
    return int(mesh.shape["mp"])


def _xavier(w: torch.Tensor, fan_in: int, fan_out: int):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.normal_(0.0, std)


class VocabParallelEmbedding(nn.Embedding):
    """Embedding table ``[V, H]`` marked ``("mp", None)``."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
        _xavier(self.weight, num_embeddings, embedding_dim)
        mark_param(self.weight, ("mp", None))

    def forward(self, x):
        mp = _mp()
        if mp <= 1 or self.num_embeddings % mp:
            return F.embedding(x, self.weight)
        rows = self.num_embeddings // mp
        parts = []
        for s in range(mp):
            local = x - s * rows
            hit = (local >= 0) & (local < rows)
            e = F.embedding(local.clamp(0, rows - 1),
                            self.weight[s * rows:(s + 1) * rows])
            parts.append(e * hit.unsqueeze(-1).to(e.dtype))
        return reduce_in_slot_order(parts)


class ColumnParallelLinear(nn.Linear):
    """``x @ W + b`` with ``W [in, out]`` split over its outputs (torch
    holds ``[out, in]``). ``gather_output`` concatenates the slots'
    outputs; without it the slots' outputs come back as a list."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        bias = has_bias or has_bias is None
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=dtype)
        _xavier(self.weight, in_features, out_features)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()
            mark_param(self.bias, ("mp",))
        mark_param(self.weight, (None, "mp"))
        self.gather_output = gather_output

    def forward(self, x):
        mp = _mp()
        if mp <= 1 or self.out_features % mp:
            return F.linear(x, self.weight, self.bias)
        n = self.out_features // mp
        outs = [F.linear(x, self.weight[s * n:(s + 1) * n],
                         None if self.bias is None
                         else self.bias[s * n:(s + 1) * n])
                for s in range(mp)]
        return torch.cat(outs, dim=-1) if self.gather_output else outs


class RowParallelLinear(nn.Linear):
    """``x @ W + b`` with ``W [in, out]`` split over its inputs: each slot
    multiplies its block of ``x``'s features, the partial products are
    summed in slot order (in float32, rounded once), then the replicated
    bias is added. ``input_is_parallel`` takes ``x`` as the slots' list."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bool(has_bias),
                         device=device, dtype=dtype)
        _xavier(self.weight, in_features, out_features)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()
            mark_param(self.bias, (None,))
        mark_param(self.weight, ("mp", None))
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        mp = _mp()
        if mp <= 1 or self.in_features % mp:
            if isinstance(x, (list, tuple)):
                x = torch.cat(list(x), dim=-1)
            return F.linear(x, self.weight, self.bias)
        n = self.in_features // mp
        xs = list(x) if isinstance(x, (list, tuple)) else \
            [x[..., s * n:(s + 1) * n] for s in range(mp)]
        out = reduce_in_slot_order(
            [F.linear(xs[s], self.weight[:, s * n:(s + 1) * n])
             for s in range(mp)])
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(nn.Module):
    """Vocab-parallel softmax cross entropy (reference ``mp_layers.py:
    558``): per-row losses, ``ignore_index`` rows 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        if label.ndim == input.ndim:
            label = label.squeeze(-1)
        return F.cross_entropy(input.float(), label.long(), reduction="none",
                               ignore_index=self.ignore_index)


def get_rng_state_tracker():
    """The reference's TP-rank dropout helper: every slot of one process
    draws from the port's one generator, so the tracker's scopes are
    empty."""
    import contextlib

    class _Tracker:
        def add(self, name, seed):
            pass

        @contextlib.contextmanager
        def rng_state(self, name="global_seed"):
            yield

    return _Tracker()
