"""``paddle.DataParallel``: the port of ``paddle_tpu/distributed/parallel.py``.

In a world of one, ``DataParallel`` is the wrapped model itself, with the
reference's ``scale_loss`` and ``apply_collective_grads`` (nothing to scale
or reduce) and its state dict under the wrapped model's names.

In a world above one (``init_parallel_env`` first) it keeps the reference's
contract, that every replica trains the same model on its own shard of the
batch and steps on the replicas' averaged gradient:

- at wrap, every parameter and buffer is broadcast from the group's first
  rank, so the replicas start equal;
- at the end of each backward, the gradients are averaged over the group:
  one all-reduce a dtype and device, over a flat float32 buffer (the sum of
  the ranks' gradients, divided by the group's size, rounded once back to
  each gradient's dtype), so every rank holds the same bits;
- ``no_sync()`` skips that averaging: gradients accumulate locally, and the
  first backward after it averages what accumulated (gradient merge).

The averaging is queued from each parameter's post-accumulate-grad hook as
an autograd engine callback, so it runs once a backward, after the last
gradient landed. With ``find_unused_parameters`` a parameter that got no
gradient on this rank takes part with zeros; without it every parameter
must get one.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch import nn

from ..nn.layer.layers import Layer
from . import env

__all__ = ["DataParallel", "get_rank", "get_world_size",
           "init_parallel_env", "ParallelEnv"]


def get_rank(group=None) -> int:
    return env.get_rank(group)


def get_world_size(group=None) -> int:
    return env.get_world_size(group)


init_parallel_env = env.init_parallel_env
ParallelEnv = env.ParallelEnv


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        self._world = env.get_world_size(group)
        self._sync = True
        self._queued = False
        self._hooks = []
        # gradients averaged so far (one per backward that reduced)
        self.reductions = 0
        if self._world > 1:
            if not env.is_initialized():
                raise RuntimeError(
                    "DataParallel over several ranks needs "
                    "paddle.distributed.init_parallel_env() first")
            self._broadcast_state()
            for p in self._params():
                self._hooks.append(
                    p.register_post_accumulate_grad_hook(self._on_grad))

    def _params(self) -> List[torch.Tensor]:
        return [p for p in nn.Module.parameters(self._layers)
                if p.requires_grad]

    def _src(self) -> int:
        return self._group.ranks[0] if self._group is not None else 0

    @torch.no_grad()
    def _broadcast_state(self):
        from .communication.collective import broadcast
        tensors = list(nn.Module.parameters(self._layers)) + \
            [b for b in nn.Module.buffers(self._layers) if b is not None]
        for flat, members in _flat_groups(tensors):
            broadcast(flat, src=self._src(), group=self._group)
            _unflatten(flat, members, lambda t, v: t.copy_(v))

    def _on_grad(self, p):
        if not self._sync or self._queued:
            return
        self._queued = True
        torch.autograd.Variable._execution_engine.queue_callback(
            self._average_grads)

    @torch.no_grad()
    def _average_grads(self):
        from .communication.collective import all_reduce
        self._queued = False
        params = self._params()
        for p in params:
            if p.grad is None:
                if not self.find_unused_parameters:
                    raise RuntimeError(
                        "a parameter got no gradient in this backward; wrap "
                        "with find_unused_parameters=True")
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        for flat, members in _flat_groups(grads, dtype=torch.float32):
            all_reduce(flat, group=self._group)
            flat.div_(self._world)
            _unflatten(flat, members, lambda g, v: g.copy_(v))
        self.reductions += 1

    @contextlib.contextmanager
    def no_sync(self):
        """Accumulate gradients locally inside the block; the first backward
        after it averages them."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def named_parameters(self, prefix="", *args, **kwargs):
        """The wrapped model's parameters, as it hands them out (torch's
        or Paddle's), under ``_layers.``."""
        sub = f"{prefix}._layers" if prefix else "_layers"
        return self._layers.named_parameters(sub, *args, **kwargs)

    def parameters(self, *args, **kwargs):
        return [p for _, p in self.named_parameters("", *args, **kwargs)]

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """The reference's manual hook: the averaging already ran at the
        end of the backward, so nothing is left to do."""

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        if hasattr(self._layers, "set_state_dict"):
            return self._layers.set_state_dict(state_dict, *args, **kwargs)
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_dict = set_state_dict
    load_dict = set_state_dict


def _flat_groups(tensors, dtype=None):
    """``[(flat, members)]``: the tensors grouped by device and dtype, each
    group one flat buffer (in ``dtype`` when given)."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((str(t.device), t.dtype), []).append(t)
    out = []
    for members in groups.values():
        flat = torch.cat([m.detach().reshape(-1).to(dtype or m.dtype)
                          for m in members])
        out.append((flat, members))
    return out


def _unflatten(flat, members, write):
    off = 0
    for m in members:
        n = m.numel()
        write(m, flat[off:off + n].view(m.shape).to(m.dtype))
        off += n
