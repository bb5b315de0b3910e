"""hapi callbacks: the port of ``paddle_tpu/hapi/callbacks.py`` (``Callback``,
``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping``, ``config_callbacks``).

``ElasticCheckpoint`` is the hapi face of ``elastic.CheckpointManager``.
``EarlyStopping`` keeps its best weights as copies on their own device,
not on the host.
"""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "ElasticCheckpoint", "LRScheduler", "EarlyStopping",
           "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    """Calls each hook of every callback in order."""

    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kwargs)

        return call


class ProgBarLogger(Callback):
    """Prints each ``log_freq``-th step's logs and each epoch's time."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else
                f"{k}: {v}" for k, v in (logs or {}).items())
            epochs = self.params.get("epochs")
            print(f"Epoch {self._epoch + 1}/{epochs} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done in {time.time() - self._t0:.1f}s")


class ModelCheckpoint(Callback):
    """``Model.save`` to ``<save_dir>/<epoch>`` every ``save_freq``
    epochs and to ``<save_dir>/final`` at the end of training (each a
    ``.pdparams`` and a ``.pdopt`` file)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, "final"))


class ElasticCheckpoint(Callback):
    """Preemption-tolerant checkpointing for ``Model.fit``, as the
    reference's: the full training state (optimizer accumulators, LR step,
    RNG) every ``save_interval_steps`` global steps into an atomic,
    kill-9-safe checkpoint directory (``elastic.CheckpointManager``),
    restored when training starts, with SIGTERM/SIGINT wired to a final
    bounded-deadline save.

    ``fit`` replays data from the epoch start, so after a restore the
    already covered steps of the interrupted epoch run again: the state
    is never wrong, some work repeats. The restore's result is
    ``.restored``."""

    def __init__(self, directory, save_interval_steps=None,
                 save_interval_s=None, keep=None, restore=True,
                 preemption_handlers=True):
        super().__init__()
        self.directory = directory
        self._kw = {"save_interval_steps": save_interval_steps,
                    "save_interval_s": save_interval_s, "keep": keep}
        self._restore = restore
        self._preempt = preemption_handlers
        self.manager = None
        self.restored = None
        self._global_step = 0
        self._epoch = 0

    def on_train_begin(self, logs=None):
        from ..elastic import CheckpointManager
        if self.manager is None:
            self.manager = CheckpointManager(
                self.directory, model=self.model.network,
                optimizer=getattr(self.model, "_optimizer", None),
                **{k: v for k, v in self._kw.items() if v is not None})
        if self._restore:
            self.restored = self.manager.restore_latest()
            if self.restored is not None:
                self._global_step = self.restored.step
                self._epoch = self.restored.epoch or 0
        if self._preempt:
            self.manager.install_preemption_handlers()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        self.manager.step(self._global_step, epoch=self._epoch,
                          offset=step)

    def on_train_end(self, logs=None):
        if self.manager is not None:
            self.manager.save(self._global_step, epoch=self._epoch,
                              block=True, reason="final")
            self.manager.close()


class LRScheduler(Callback):
    """Steps the optimizer's LR scheduler after each step (``by_step``)
    and/or each epoch (``by_epoch``)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None) if opt is not None else None
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class EarlyStopping(Callback):
    """Stops ``fit`` when the monitored value of the evaluation logs has not
    improved for more than ``patience`` evaluations, restoring the best
    weights (``save_best_model``)."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self._op = (lambda a, b: a < b - self.min_delta) if mode == "min" \
            else (lambda a, b: a > b + self.min_delta)
        self.best = None
        self.wait = 0
        self.stopped_epoch = -1

    def _value(self, logs):
        v = (logs or {}).get(self.monitor)
        if isinstance(v, (list, tuple, np.ndarray)):
            v = float(np.asarray(v).reshape(-1)[0])
        return v

    def _snapshot(self):
        net = getattr(self.model, "network", None)
        if self.save_best_model and net is not None:
            self._best_state = {k: t._data.detach().clone()
                                for k, t in net.state_dict().items()}

    def on_eval_end(self, logs=None):
        v = self._value(logs)
        if v is None:
            return
        if self.best is None:
            # the first evaluation sets the baseline (not a wait); with an
            # explicit baseline the weights become the candidate only once
            # an evaluation beats it
            self.best = v if self.baseline is None else self.baseline
            if self.baseline is None:
                self._snapshot()
                return
        if self._op(v, self.best):
            self.best = v
            self.wait = 0
            self._snapshot()
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True
                restored = ""
                if self.save_best_model and \
                        getattr(self, "_best_state", None) is not None:
                    self.model.network.set_state_dict(self._best_state)
                    restored = (f" (best {self.monitor}={self.best:.4f} "
                                f"restored)")
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement "
                          f"for {self.wait} evals; stopping{restored}")


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=1, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    """The callback list of a ``fit``: ``callbacks`` plus a
    ``ProgBarLogger`` (with ``verbose``), a ``ModelCheckpoint`` (with
    ``save_dir``) and an ``LRScheduler`` where they lack one, and in
    training a ``TrainingTelemetryCallback`` when
    ``FLAGS_training_telemetry`` is on."""
    cbs = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbs) and verbose:
        cbs.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, ModelCheckpoint) for c in cbs) and save_dir:
        cbs.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbs) and model is not None:
        cbs.append(LRScheduler())
    if mode == "train":
        from ..framework.flags import flag_value
        if flag_value("FLAGS_training_telemetry"):
            from ..observability.training import TrainingTelemetryCallback
            if not any(isinstance(c, TrainingTelemetryCallback)
                       for c in cbs):
                cbs.append(TrainingTelemetryCallback())
    clist = CallbackList(cbs)
    clist.set_model(model)
    clist.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                      "metrics": metrics or []})
    return clist
