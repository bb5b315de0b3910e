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
- ``__call__`` runs inside a goodput ``step`` frame of the default ledger
  (``observability/goodput.py``; a checkpoint restore's replay turns the
  frame into ``recovery``) and records one ``kind="train"`` envelope into
  the default step profiler, as the reference's (``:754-776``); profiling
  never fails a step. ``run_steps`` feeds neither, as the reference's.
  Every update calls the optimizer's step observers
  (``optimizer.register_step_observer``) with its host wall time.
- Every trainable parameter is updated at every step, a parameter that got
  no gradient with a zero one, as the reference's ``value_and_grad`` gives.
- ``scaler=GradScaler(...)`` (enabled) brings dynamic loss scaling into the
  step, as the reference's (``:436-551``): the loss is scaled before
  ``backward()``, the gradients are unscaled in float32 and cast back to
  their type, ``found_inf`` is taken over all of them, a step that found one
  leaves the parameters and every accumulator untouched (t still
  advances), and the scale follows the incr/decr schedule. The scale and
  the counters stay on the device as 0-d tensors (no host sync a step,
  ``run_steps`` included) and are mirrored into the scaler after each
  step; a ``load_state_dict`` on the scaler takes effect at the next call
  (its ``_epoch`` changed, as the reference checks). A disabled scaler is
  ignored.
- Randomness (dropout) draws from the port's generator
  (``framework/random.py``), which advances with every step.
- ``donate`` (the reference's default True) is accepted and has no
  effect: parameters and optimizer state are updated in place, which is
  what the reference's buffer donation buys, so ``donate=True`` and
  ``False`` run the same step.

- xstats (``observability/xstats.py``): the first step of each batch
  signature runs under the registry's counters and registers the
  ``train_step`` entry (FLOPs per step, bytes, allocator memory); later
  steps only bump its counters. The ``kind="train"`` envelope then joins
  it into ``paddle_mfu{kind="train"}``.
- The compile cache (``compile_cache/``, on when ``FLAGS_compile_cache_dir``
  is set): the site ``train_step``, keyed as the reference keys it
  (``:205-300``): the model's, the loss function's and the optimizer's
  identity (its class, update rule, accumulators, decay and learning-rate
  multipliers, grad clip), the AMP level and the scaler's schedule, the
  batch signature and the compile-relevant flags. A fresh step on a warm
  directory loads the first step's record and skips its measurement; the
  step itself runs as without the cache.
- Numerics tripwires (``observability/numerics.py``), armed when the step
  is built by ``FLAGS_check_nan_inf`` (every step) or
  ``FLAGS_numerics_sample_rate`` (a sampled share), as the reference's
  (``:154-165, 297-381, 452-456``): after the backward, on the device,
  the global norm of the (unscaled) gradients over their finite
  elements, their finite fraction and whether the loss is finite, noted
  with the loss scale after the step's schedule; the numerics layer
  publishes them one note later (grad-norm EWMA drift, anomalies), so no
  step waits for them.

Not in this slice: a step under a dp/mp/sep mesh and DGC/LocalSGD (ROADMAP
queue 1 item 5c, part 2) and ASP masks (item 5d). Asking for any of them
raises ``NotImplementedError`` naming its ROADMAP item. Data parallelism
over processes rides the model: a ``distributed.DataParallel`` model
averages its gradients at the end of the step's backward.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch

from ..amp.auto_cast import auto_cast
from ..observability import numerics, xstats
from ..optimizer import optimizer as opt_mod

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
        # donate is accepted for the reference's surface and has no
        # effect: the step updates parameters and optimizer state in
        # place, which is what the reference's buffer donation buys
        del donate
        for attr in ("_dgc_cfg", "_localsgd_cfg"):
            if getattr(optimizer, attr, None) is not None:
                raise NotImplementedError(
                    "DGC/LocalSGD optimizers are not ported yet (ROADMAP "
                    "queue 1 item 5c, part 2)")
        if amp_level not in (None, "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O1' or 'O2', got "
                             f"{amp_level!r}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._amp_level = amp_level
        self._amp_dtype = amp_dtype
        self._scaler = scaler if (scaler is not None
                                  and scaler.is_enable()) else None
        self._scaler_state = None
        self._scaler_epoch = None
        self._named = [(n, p) for n, p in model.named_parameters()
                       if p.requires_grad]
        for n, p in self._named:
            if getattr(p, "_asp_mask", None) is not None:
                raise NotImplementedError(
                    f"{n} carries an ASP sparsity mask; ASP is not ported "
                    f"yet (ROADMAP queue 1 item 5d)")
        optimizer._bind(self._named)
        self._params = [p for _, p in self._named]
        self._n_inputs = None
        # xstats memo: (tag, batch shapes) -> ExecEntry
        self._xstats_memo = {}
        self._step_fp: Optional[str] = None
        # numerics tripwires: armed state pinned at construction
        self._numerics_armed = (numerics.train_tripwire_armed()
                                and bool(self._params))

    @property
    def _device(self) -> torch.device:
        return self._params[0].device

    def _tensor(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        if t.device.type == "cpu" and self._device.type == "cuda":
            # a copy from pageable host memory first waits for the stream
            # (every queued kernel): a batch from io.DataLoader is pinned
            # and copied without blocking, as the reference's device_put
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _scaler_tensors(self) -> dict:
        """The scaler's scale and counters as 0-d device tensors, seeded
        from the scaler at the first call and again after its
        ``load_state_dict`` (reference ``:817-834``)."""
        sc = self._scaler
        if self._scaler_state is None or self._scaler_epoch != sc._epoch:
            dev = self._device
            self._scaler_epoch = sc._epoch
            self._scaler_state = {
                "scale": torch.tensor(float(sc._scale), dtype=torch.float32,
                                      device=dev),
                "good": torch.tensor(int(sc._good_steps), dtype=torch.int32,
                                     device=dev),
                "bad": torch.tensor(int(sc._bad_steps), dtype=torch.int32,
                                    device=dev)}
        return self._scaler_state

    def _schedule(self, st: dict, found_inf) -> None:
        """The incr/decr schedule on the device (reference ``:531-546``),
        mirrored into the scaler."""
        sc = self._scaler
        scale, good, bad = st["scale"], st["good"], st["bad"]
        if sc._dynamic:
            zero = torch.zeros_like(good)
            good = torch.where(found_inf, zero, good + 1)
            bad = torch.where(found_inf, bad + 1, zero)
            dec = bad >= sc._decr_every
            inc = good >= sc._incr_every
            scale = torch.where(dec, torch.clamp(scale * sc._decr_ratio,
                                                 min=1.0), scale)
            scale = torch.where(inc, scale * sc._incr_ratio, scale)
            bad = torch.where(dec, zero, bad)
            good = torch.where(inc, zero, good)
        self._scaler_state = {"scale": scale, "good": good, "bad": bad}
        sc._scale, sc._good_steps, sc._bad_steps = scale, good, bad
        sc._found_inf = found_inf

    def _step(self, batch, lr: float, t: int):
        """Forward, loss, backward, clip and update at ``lr`` and step
        ``t`` (with a scaler: scaled, unscaled, skipped on an overflow);
        the loss as a float32 0-d tensor (no host sync)."""
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
        st = self._scaler_tensors() if self._scaler is not None else None
        (loss if st is None else loss * st["scale"]).backward()
        params_grads = [(p, p.grad if p.grad is not None
                         else torch.zeros_like(p)) for p in self._params]
        for p in self._params:
            p.grad = None
        found_inf = None
        if st is not None:
            with torch.no_grad():
                # in place, in float32 and rounded to each gradient's type;
                # then one pass that sets `found` if any unscaled gradient
                # is not finite (multiplying them by 1, which keeps them)
                grads = [g for _, g in params_grads]
                torch._foreach_mul_(grads, 1.0 / st["scale"])
                found = torch.zeros((), device=self._device)
                torch._amp_foreach_non_finite_check_and_unscale_(
                    grads, found, torch.ones((), device=self._device))
                found_inf = found > 0
        num_stats = None
        if self._numerics_armed and numerics.sample_decision(
                numerics.tripwire_rate()):
            # the gradients' health after the unscale, before the clip
            with torch.no_grad():
                num_stats = numerics.grad_stats(
                    [g for _, g in params_grads], loss)
        t0 = time.perf_counter() if opt_mod._step_observers else None
        clip = self.optimizer._grad_clip
        if clip is not None:
            params_grads = clip(params_grads)
        self.optimizer._apply(params_grads, lr, t, skip=found_inf)
        opt_mod.notify_step_observers(self.optimizer, t0, len(params_grads))
        if st is not None:
            self._schedule(st, found_inf)
        if num_stats is not None:
            try:
                numerics.note_train_step(
                    num_stats, loss_scale=(self._scaler_state["scale"]
                                           if st is not None else None))
            except Exception:  # noqa: BLE001 - observability is garnish
                pass           # on the hot path, never a step failure
        return loss.detach()

    def _step_fingerprint(self) -> str:
        """The step's identity for compile-cache keys (reference
        ``:195-250``): everything that changes what a step computes,
        besides the batch signature and the flags the key adds."""
        if self._step_fp is not None:
            return self._step_fp
        from ..compile_cache import fingerprint as fpmod
        opt = self.optimizer
        parts = [
            fpmod.layer_fingerprint(self.model),
            fpmod.function_fingerprint(self.loss_fn),
            f"{type(opt).__module__}.{type(opt).__qualname__}",
            fpmod.function_fingerprint(opt._update_rule),
            repr(sorted(opt._accum_names)),
            repr((self._amp_level, self._amp_dtype)),
            repr(getattr(opt, "_l2_coeff", None)),
            repr(("numerics", self._numerics_armed)),
        ]
        gc = getattr(opt, "_grad_clip", None)
        parts.append(repr((type(gc).__qualname__ if gc is not None
                           else None,
                           getattr(gc, "clip_norm", None),
                           getattr(gc, "min", None),
                           getattr(gc, "max", None))))
        sc = self._scaler
        if sc is not None:
            parts.append(repr((float(sc._incr_ratio), float(sc._decr_ratio),
                               int(sc._incr_every), int(sc._decr_every),
                               bool(sc._dynamic))))
        for n, p in sorted(self._named, key=lambda np_: np_[0]):
            mult = getattr(p, "optimize_attr",
                           {"learning_rate": 1.0}).get("learning_rate", 1.0)
            parts.append(f"{n}:{opt._wd_for(p)}:{mult}")
        self._step_fp = fpmod.bytes_fingerprint("\n".join(parts).encode())
        return self._step_fp

    def _dispatch(self, batch, lr: float, t: int):
        """One step as a dispatch of the ``train_step`` site: the first
        of each batch signature is measured and registered by xstats
        (the entry's signature: the reference's tag, the batch, the
        parameters)."""
        key = ("single", tuple((tuple(getattr(b, "shape", ())),
                                str(getattr(b, "dtype", "")))
                               for b in batch))
        return xstats.observed_call(
            self._xstats_memo, key, "train_step",
            lambda: self._step(batch, lr, t),
            signature_fn=lambda: ((((0,), "tag:single"),)
                                  + xstats.signature_of(list(batch))
                                  + xstats.signature_of(self._params)),
            kind="train", device=self._device,
            identity=self._step_fingerprint)

    def _set_inputs(self, batch, n_inputs):
        if n_inputs is not None:
            self._n_inputs = n_inputs
        elif self._n_inputs is None:
            self._n_inputs = len(batch) - 1

    def __call__(self, *batch, n_inputs: Optional[int] = None):
        """``batch`` = the model's inputs, then ``loss_fn``'s extra
        arguments (labels); ``n_inputs`` says how many are inputs (default:
        all but the last). Returns the loss."""
        from ..observability.goodput import default_ledger
        from ..observability.stepprof import default_profiler
        ledger = default_ledger()
        ledger.begin("step")
        try:
            self._set_inputs(batch, n_inputs)
            self.optimizer._step_count += 1
            out = self._dispatch(batch, self.optimizer.get_lr(),
                                 self.optimizer._step_count)
        finally:
            wall_s = ledger.end()
            try:
                default_profiler().record_step(
                    wall_s * 1e3, kind="train",
                    step=int(self.optimizer._step_count))
            except Exception:  # noqa: BLE001 - profiling never fails
                pass           # the step it measures
        return out

    def run_steps(self, n_steps: int, *batch,
                  n_inputs: Optional[int] = None):
        """``n_steps`` steps on the same batch, the learning rate held for
        the window; one host sync at the end. Returns the last loss."""
        self._set_inputs(batch, n_inputs)
        lr = self.optimizer.get_lr()
        loss = None
        for _ in range(n_steps):
            self.optimizer._step_count += 1
            loss = self._dispatch(batch, lr, self.optimizer._step_count)
        if loss is not None and loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        return loss
