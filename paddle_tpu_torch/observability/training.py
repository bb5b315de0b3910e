"""Training-step instrumentation: the port of
``paddle_tpu/observability/training.py``, a hapi ``Model.fit`` callback and
an optimizer step observer, both reporting into the metric registry.

``TrainingTelemetryCallback`` is duck-typed against the hapi callback
surface (it implements every ``on_*`` hook) rather than inheriting
``hapi.callbacks.Callback``, so this module sits below hapi in the import
order; scripts add it to ``callbacks=[...]``.

``instrument_optimizers()`` registers a step observer with
``paddle_tpu_torch.optimizer`` so every optimizer update (``step()``, and
``jit.TrainStep``'s update) records its duration, parameter count and
current learning rate, covering raw training loops that never go through
hapi. The duration is the host's wall time of the update call; on a GPU
that is the time to enqueue the update, not the device's time.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from .registry import MetricRegistry, default_registry

__all__ = ["TrainingTelemetryCallback", "instrument_optimizers",
           "uninstrument_optimizers"]


class TrainingTelemetryCallback:
    """Records per-step training metrics from the fit loop:

    - ``paddle_training_steps_total`` / ``paddle_training_epochs_total``
    - ``paddle_training_step_ms`` histogram (bounded-window percentiles)
    - ``paddle_training_loss`` gauge (last step's loss)
    - ``paddle_training_examples_per_sec`` gauge when ``batch_size`` is
      known (pass it to the constructor; the fit loop's loader owns it
      and does not forward it through callback params).

    It is also the fit loop's feed into the goodput ledger and the
    continuous step profiler: each train batch opens a ``step`` frame
    (nested compile/checkpoint recordings subtract themselves, so the
    accounting identity holds), the gap between one batch's end and
    the next one's begin is attributed to ``data_stall`` (the input
    pipeline had the wheel), and every step drops an envelope into the
    step profiler's ring (straggler detection included).

    ``now`` is injected for deterministic tests.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 batch_size: Optional[int] = None,
                 now: Callable[[], float] = time.monotonic,
                 ledger=None, step_profiler=None):
        from .goodput import default_ledger
        from .stepprof import default_profiler
        reg = registry or default_registry()
        self._now = now
        self.batch_size = batch_size
        self._ledger = ledger if ledger is not None else \
            default_ledger()
        self._prof = step_profiler if step_profiler is not None else \
            default_profiler()
        self._t_batch_end = None
        self._frame_open = False
        self._steps = reg.counter(
            "paddle_training_steps_total", "optimizer steps seen by the "
            "hapi fit loop")
        self._epochs = reg.counter(
            "paddle_training_epochs_total", "completed fit epochs")
        self._step_ms = reg.histogram(
            "paddle_training_step_ms", "wall time of one fit train step "
            "(forward+backward+update)")
        self._loss = reg.gauge(
            "paddle_training_loss", "last training-step loss")
        self._eps = reg.gauge(
            "paddle_training_examples_per_sec",
            "examples/sec from the last step (needs batch_size)")
        self.model = None
        self.params = {}
        self._t0 = None

    # -- hapi callback surface (duck-typed)
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    def on_train_begin(self, logs=None):
        self._ledger.start()
        self._t_batch_end = None

    def on_train_end(self, logs=None):
        # post-fit time is idle/eval, not input stall
        self._t_batch_end = None

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        self._epochs.inc()

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = self._now()
        if self._t_batch_end is not None:
            # the time between the previous step's end and this one's
            # begin belonged to the input pipeline
            gap = self._now() - self._t_batch_end
            self._t_batch_end = None
            if gap > 0:
                self._ledger.record("data_stall", gap)
        self._ledger.begin("step")
        self._frame_open = True

    def on_train_batch_end(self, step, logs=None):
        if self._frame_open:
            self._frame_open = False
            self._ledger.end()
        self._t_batch_end = self._now()
        self._steps.inc()
        if self._t0 is not None:
            dt = self._now() - self._t0
            self._t0 = None
            self._step_ms.observe(dt * 1e3)
            self._prof.record_step(dt * 1e3, kind="train",
                                   step=int(step) if step is not None
                                   else None)
            if self.batch_size and dt > 0:
                self._eps.set(self.batch_size / dt)
        loss = (logs or {}).get("loss")
        if loss is not None:
            try:
                self._loss.set(float(loss))
            except (TypeError, ValueError):
                pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


_optimizer_observer = None


def instrument_optimizers(registry: Optional[MetricRegistry] = None
                          ) -> bool:
    """Hook every Optimizer.apply_gradients in the process. Idempotent;
    returns True once the observer is registered."""
    global _optimizer_observer
    if _optimizer_observer is not None:
        return True
    reg = registry or default_registry()
    steps = reg.counter(
        "paddle_optimizer_steps_total",
        "optimizer update calls (apply_gradients)", ("optimizer",))
    step_ms = reg.histogram(
        "paddle_optimizer_step_ms",
        "wall time of one optimizer update", ("optimizer",))
    lr_gauge = reg.gauge(
        "paddle_optimizer_lr", "current learning rate", ("optimizer",))
    params_gauge = reg.gauge(
        "paddle_optimizer_params",
        "parameter tensors updated by the last step", ("optimizer",))

    def _observer(opt, duration_s, n_params):
        name = type(opt).__name__
        steps.labels(optimizer=name).inc()
        step_ms.labels(optimizer=name).observe(duration_s * 1e3)
        params_gauge.labels(optimizer=name).set(n_params)
        try:
            lr_gauge.labels(optimizer=name).set(float(opt.get_lr()))
        except Exception:  # noqa: BLE001 - LR is best-effort garnish
            pass

    from ..optimizer import optimizer as opt_mod
    opt_mod.register_step_observer(_observer)
    _optimizer_observer = _observer
    return True


def uninstrument_optimizers():
    global _optimizer_observer
    if _optimizer_observer is None:
        return
    from ..optimizer import optimizer as opt_mod
    opt_mod.unregister_step_observer(_optimizer_observer)
    _optimizer_observer = None
