"""TrainStep: the port of ``paddle_tpu/jit/train_step.py``.

One training step, eagerly: the forward and the loss under the port's
``auto_cast`` (when ``amp_level`` is set), ``backward()``, the optimizer's
grad clip and update. The reference compiles the same step into one XLA
program; here PyTorch runs it op by op and the attention goes through the
hand-written flash kernels forward and backward.

- ``__call__`` advances the optimizer's ``_step_count`` before the step, so
  the bias correction's t starts at 1 (reference ``:813-815``), and returns
  the loss as a float32 0-d tensor without waiting for the device.
- ``run_steps(n, *batch)`` runs n steps on the same batch at the learning
  rate of the window's start, t advancing once per step, and synchronises
  with the device once, at the end (reference ``:614-675``).
- Every trainable parameter is updated at every step, a parameter that got
  no gradient with a zero one, as the reference's ``value_and_grad`` gives.

Not in this slice: buffer donation, meshes, the compile cache and xstats,
the numerics tripwires, DGC/LocalSGD, ASP masks and the fp16 ``GradScaler``.
Asking for any of them raises ``NotImplementedError`` naming its ROADMAP
item.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..amp.auto_cast import auto_cast

__all__ = ["TrainStep"]


class TrainStep:
    """Usage::

        step = TrainStep(model, loss_fn, optimizer, amp_level="O2")
        loss = step(ids, labels)           # loss_fn(model(ids), labels)
        loss = step.run_steps(10, ids, labels)
    """

    def __init__(self, model, loss_fn: Callable, optimizer,
                 donate: Optional[bool] = None,
                 amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16", scaler=None):
        if donate is not None:
            raise NotImplementedError(
                "buffer donation is not ported: the port updates parameters "
                "and optimizer state in place (ROADMAP queue 1 item 11: the "
                "compiled step's features)")
        if scaler is not None:
            raise NotImplementedError(
                "the fp16 GradScaler is not ported yet (ROADMAP queue 1 item "
                "6: dynamic loss scaling)")
        for attr in ("_dgc_cfg", "_localsgd_cfg"):
            if getattr(optimizer, attr, None) is not None:
                raise NotImplementedError(
                    "DGC/LocalSGD optimizers are not ported yet (ROADMAP "
                    "queue 1 item 11: the compiled step's features)")
        if amp_level not in (None, "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O1' or 'O2', got "
                             f"{amp_level!r}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._amp_level = amp_level
        self._amp_dtype = amp_dtype
        self._named = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        for n, p in self._named:
            if getattr(p, "_asp_mask", None) is not None:
                raise NotImplementedError(
                    f"{n} carries an ASP sparsity mask; ASP is not ported "
                    f"yet (ROADMAP queue 1 item 11: the compiled step's "
                    f"features)")
        optimizer._bind(self._named)
        self._params = [p for _, p in self._named]
        self._n_inputs = None

    @property
    def _device(self) -> torch.device:
        return self._params[0].device

    def _tensor(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return t.to(self._device)

    def _step(self, batch, lr: float, t: int):
        """Forward, loss, backward, clip and update at ``lr`` and step
        ``t``; the loss as a float32 0-d tensor (no host sync)."""
        arrays = [self._tensor(b) for b in batch]
        n = self._n_inputs
        for p in self._params:
            p.grad = None
        amp = (auto_cast(level=self._amp_level, dtype=self._amp_dtype)
               if self._amp_level else contextlib.nullcontext())
        with amp:
            out = self.model(*arrays[:n])
            loss = self.loss_fn(out, *arrays[n:])
        loss = loss.float()
        loss.backward()
        params_grads = [(p, p.grad if p.grad is not None
                         else torch.zeros_like(p)) for p in self._params]
        for p in self._params:
            p.grad = None
        clip = self.optimizer._grad_clip
        if clip is not None:
            params_grads = clip(params_grads)
        self.optimizer._apply(params_grads, lr, t)
        return loss.detach()

    def _set_inputs(self, batch, n_inputs):
        if n_inputs is not None:
            self._n_inputs = n_inputs
        elif self._n_inputs is None:
            self._n_inputs = len(batch) - 1

    def __call__(self, *batch, n_inputs: Optional[int] = None):
        """``batch`` = the model's inputs, then ``loss_fn``'s extra
        arguments (labels); ``n_inputs`` says how many are inputs (default:
        all but the last). Returns the loss."""
        self._set_inputs(batch, n_inputs)
        self.optimizer._step_count += 1
        return self._step(batch, self.optimizer.get_lr(),
                          self.optimizer._step_count)

    def run_steps(self, n_steps: int, *batch,
                  n_inputs: Optional[int] = None):
        """``n_steps`` steps on the same batch, the learning rate held for
        the window; one host sync at the end. Returns the last loss."""
        self._set_inputs(batch, n_inputs)
        lr = self.optimizer.get_lr()
        loss = None
        for _ in range(n_steps):
            self.optimizer._step_count += 1
            loss = self._step(batch, lr, self.optimizer._step_count)
        if loss is not None and loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        return loss
