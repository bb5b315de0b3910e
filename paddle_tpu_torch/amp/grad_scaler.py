"""Dynamic loss scaling: the port of ``paddle_tpu/amp/grad_scaler.py``
(``GradScaler``, ``AmpScaler``).

float16 training scales the loss so that small gradients survive the
float16 backward, unscales the gradients, and skips the update of a step
whose gradients overflowed (``found_inf``), adjusting the scale on the
reference's schedule: after ``decr_every_n_nan_or_inf`` bad steps the scale
is multiplied by ``decr_ratio`` (never below 1.0), after
``incr_every_n_steps`` good steps by ``incr_ratio``; a good step resets the
bad count and a bad one the good count.

Two ways to drive it, as the reference:

- eagerly, around the port's ``Optimizer``: ``scaler.scale(loss)
  .backward()``, ``scaler.step(opt)`` (unscales unless ``unscale_`` already
  did, steps only without an overflow), ``scaler.update()``; or
  ``scaler.minimize(opt, scaled_loss)`` for all three;
- inside ``jit.TrainStep(..., scaler=scaler)``, which keeps the scale and
  the counters as tensors on the device (no host sync a step) and mirrors
  them into this object after each step: ``state_dict()`` reads them back,
  and ``load_state_dict`` bumps ``_epoch`` so the step reseeds from it at
  its next call. Do not call ``update()`` yourself then: the step does.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


def _num(x):
    """A Python number from a number or a 0-d tensor (host sync)."""
    return x.item() if isinstance(x, torch.Tensor) else x


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._epoch = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient of ``optimizer``'s parameters by
        1 / scale, in its own type, and record whether any was not finite
        (one host sync)."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameters or []
                 if p.grad is not None]
        inv = 1.0 / _num(self._scale)
        found = False
        if grads:
            finite = torch.stack([torch.isfinite(g).all() for g in grads])
            found = not bool(finite.all())
            for g in grads:
                g.copy_((g * inv).to(g.dtype))
        self._found_inf = found
        self._unscaled = True

    def step(self, optimizer):
        """``optimizer.step()`` unless the unscaled gradients overflowed
        (unscaling first unless :meth:`unscale_` already ran)."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not bool(_num(self._found_inf)):
            optimizer.step()
        self._unscaled = False

    def update(self):
        """The reference's incr/decr schedule, after :meth:`step`."""
        if not self._enable or not self._dynamic:
            return
        scale, good, bad = (_num(self._scale), _num(self._good_steps),
                            _num(self._bad_steps))
        if bool(_num(self._found_inf)):
            bad, good = bad + 1, 0
            if bad >= self._decr_every:
                scale = max(scale * self._decr_ratio, 1.0)
                bad = 0
        else:
            good, bad = good + 1, 0
            if good >= self._incr_every:
                scale *= self._incr_ratio
                good = 0
        self._scale, self._good_steps, self._bad_steps = scale, good, bad

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        # TrainStep leaves device tensors here: read them back
        return {"scale": float(_num(self._scale)),
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": int(_num(self._good_steps)),
                "decr_count": int(_num(self._bad_steps))}

    def load_state_dict(self, state):
        self._scale = float(_num(state.get("scale", self._scale)))
        self._good_steps = int(_num(state.get("incr_count", 0)))
        self._bad_steps = int(_num(state.get("decr_count", 0)))
        # a TrainStep reseeds its device state at its next call
        self._epoch += 1


AmpScaler = GradScaler
