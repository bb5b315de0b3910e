"""``paddle.Model``: the port of ``paddle_tpu/hapi/model.py``, the high-level
train / evaluate / predict API over a ``Layer`` (the reference's
``python/paddle/hapi/model.py:1045``).

``prepare`` wires the optimizer, the loss, the metrics and AMP
(``amp_configs``: "O1", "O2" or a dict with "level" and ``GradScaler``'s
arguments). ``fit``, ``evaluate`` and ``predict`` read batches from the
port's ``io.DataLoader`` (or take one) and move them to the current place;
each training step reads its loss back to the host (``float``), as the
reference's does, and the metrics update on the host from what their
``compute`` made on the device. AMP covers the training forward only;
evaluation and prediction run in the network's own precision, as the
reference's do. ``save(training=False)`` exports through
``jit.save``. In a world above one (the launcher's ranks,
``distributed.init_parallel_env``), ``fit`` reads each rank's shard of the
data through a ``DistributedBatchSampler``, as the reference's
(``hapi/model.py:50-56``). With ``FLAGS_training_telemetry`` set, ``fit``
adds a ``TrainingTelemetryCallback`` to its callbacks (reference
``hapi/callbacks.py:297-302``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.autograd import no_grad
from ..core.tensor import Tensor, to_tensor
from ..framework.device import current_device
from ..io import DataLoader


def _feed(x):
    """A batch element as a Paddle tensor on the current place."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x.to(current_device(), non_blocking=True))
    return to_tensor(np.asarray(x))


def _as_list(x):
    return x if x is None or isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._inputs = _as_list(inputs)
        self._labels = labels
        self._amp_level = None
        self._scaler = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, **kwargs):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = list(_as_list(metrics))
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                amp_configs = {"level": amp_configs}
            self._amp_level = amp_configs.get("level", "O1")
            if self._amp_level not in ("O0", None):
                from ..amp import GradScaler
                scaler_kw = {k: v for k, v in amp_configs.items()
                             if k in ("init_loss_scaling", "incr_ratio",
                                      "decr_ratio", "incr_every_n_steps",
                                      "decr_every_n_nan_or_inf")}
                self._scaler = GradScaler(enable=True, **scaler_kw)

    def _loader(self, data, batch_size, shuffle, num_workers=0,
                distributed=True):
        if data is None or isinstance(data, DataLoader):
            return data
        from ..distributed import get_world_size
        if distributed and get_world_size() > 1:
            from ..io import DistributedBatchSampler
            sampler = DistributedBatchSampler(
                data, batch_size=batch_size, shuffle=shuffle,
                drop_last=shuffle)
            return DataLoader(data, batch_sampler=sampler,
                              num_workers=num_workers)
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=shuffle, num_workers=num_workers)

    def _amp(self):
        """The training forward's AMP block (none without a level)."""
        if self._amp_level in (None, "O0"):
            return contextlib.nullcontext()
        from ..amp import auto_cast
        return auto_cast(level=self._amp_level)

    def _update_metrics(self, outputs, labels):
        for m in self._metrics:
            m.update(m.compute(outputs, *labels))
        return [m.accumulate() for m in self._metrics]

    def train_batch(self, inputs, labels=None, update=True):
        """One step: forward, loss, backward and (with ``update``) the
        optimizer's step through the scaler when AMP is on. Returns
        ``([loss], [metric values])``."""
        self.network.train()
        inputs = [_feed(x) for x in _as_list(inputs)]
        labels = [_feed(y) for y in _as_list(labels) or []]
        with self._amp():
            outputs = self.network(*inputs)
            losses = self._loss(outputs, *labels) if labels \
                else self._loss(outputs)
        if self._scaler is not None:
            self._scaler.scale(losses).backward()
            if update:
                self._scaler.step(self._optimizer)
                self._scaler.update()
                self._optimizer.clear_grad()
        else:
            losses.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        return [float(losses)], metrics

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = [_feed(x) for x in _as_list(inputs)]
        labels = [_feed(y) for y in _as_list(labels) or []]
        with no_grad():
            outputs = self.network(*inputs)
            losses = self._loss(outputs, *labels) if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        return ([float(losses)] if losses is not None else [], metrics)

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = [_feed(x) for x in _as_list(inputs)]
        with no_grad():
            return self.network(*inputs)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            **kwargs):
        from .callbacks import config_callbacks
        loader = self._loader(train_data, batch_size, shuffle, num_workers)
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                log_freq=log_freq, verbose=verbose,
                                save_freq=save_freq, save_dir=save_dir,
                                metrics=[m.name() for m in self._metrics])
        history = {"loss": []}
        self.stop_training = False
        cbks.on_train_begin()
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                x, y = batch[0], batch[1] if len(batch) > 1 else None
                loss, metrics = self.train_batch(x, y)
                history["loss"].append(loss[0])
                logs = {"loss": loss[0]}
                for m, v in zip(self._metrics, metrics):
                    logs[m.name()] = v
                cbks.on_train_batch_end(step, logs)
            epoch_logs = {"loss": history["loss"][-1]
                          if history["loss"] else None}
            for m in self._metrics:
                epoch_logs[m.name()] = m.accumulate()
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_result = self.evaluate(eval_data, batch_size=batch_size,
                                            verbose=verbose, callbacks=cbks)
                for k, v in eval_result.items():
                    epoch_logs[f"eval_{k}"] = v[0] if isinstance(
                        v, (list, tuple)) and v else v
                history.setdefault("eval_loss", []).extend(
                    eval_result.get("loss", []))
            cbks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        cbks.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, **kwargs):
        from .callbacks import CallbackList
        if isinstance(callbacks, CallbackList):
            cbks = callbacks
        else:
            cbks = CallbackList(callbacks or [])
            cbks.set_model(self)
        # every rank evaluates the whole set, so that callbacks deciding on
        # its result (EarlyStopping) agree across ranks
        loader = self._loader(eval_data, batch_size, False,
                              distributed=False)
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            x, y = batch[0], batch[1] if len(batch) > 1 else None
            loss, _ = self.eval_batch(x, y)
            losses.extend(loss)
            cbks.on_eval_batch_end(step, {"loss": loss[0] if loss else None})
        result = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            result[m.name()] = m.accumulate()
        cbks.on_eval_end({"loss": result["loss"][0] if result["loss"]
                          else None, **{m.name(): result[m.name()]
                                        for m in self._metrics}})
        if verbose:
            print("Eval:", result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1, **kwargs):
        loader = self._loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outputs.append(self.predict_batch(x))
        return outputs

    def save(self, path, training=True):
        """``path.pdparams`` (and ``path.pdopt`` with an optimizer); with
        ``training=False`` the network exported by ``jit.save`` with the
        ``inputs`` given to ``Model``."""
        from ..framework.io import save
        if not training:
            if not self._inputs:
                raise ValueError(
                    "Model.save(training=False) needs inputs= InputSpec "
                    "at Model() construction to trace the export")
            from ..jit.api import save as jit_save
            jit_save(self.network, path, input_spec=list(self._inputs))
            return
        save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load_paddle
        self.network.set_state_dict(load_paddle(path + ".pdparams"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
