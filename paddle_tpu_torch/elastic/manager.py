"""CheckpointManager, full-training-state capture with kill -9 recovery:
the port of ``paddle_tpu/elastic/manager.py``.

Elasticity here is job-level restart plus checkpoint resume, as the
reference's. The manager owns the checkpoint side of that contract on
top of the crash-safe ``framework.checkpoint`` layer:

- **full state**: the model's ``state_dict`` (the port's torch modules
  and its Paddle-API ``nn.Layer``), the optimizer's accumulators, its
  step count and LR scheduler, the global step, the dataloader's
  epoch/offset, numpy's global RNG and the port's generator (every device
  stream of ``framework.random``), so ``restore_latest()`` resumes bit for
  bit;
- **off the critical path**: a save copies the state to host memory
  synchronously (on a stream of its own, so only the copy stalls the
  caller, into a page-locked buffer the manager keeps from its first save
  to ``close()``) and hashes, writes and commits on a writer thread; at
  most one save is in flight: the next one first waits for the previous;
- **cadence**: every ``FLAGS_ckpt_interval_steps`` steps or every
  ``FLAGS_ckpt_interval_s`` seconds through ``step()``, the one call a
  training loop adds (``now`` is injected for tests);
- **preemption**: ``install_preemption_handlers()`` turns SIGTERM/SIGINT
  into a bounded-deadline ``final_save`` at the next step boundary
  (``step()``, or ``close()`` after the last step), then the signal's
  previous disposition (``preemption.py``);
- **recovery**: ``restore_latest()`` walks the checkpoints newest first,
  quarantining a corrupt or partial directory (``<dir>.corrupt-*``) and
  falling back to the one before;
- **observability**: the ``paddle_ckpt_*`` families of the reference, a
  ``/healthz`` staleness check, and the goodput ledger's feeds: the
  synchronous half of every save is ``ckpt_save``, restores are
  ``ckpt_restore``, and a restore's steps-lost count arms replay, so the
  re-run steps land in ``recovery``.

Steps lost are measured: ``step()`` drops a small atomic ``PROGRESS``
marker each call, and ``restore_latest()`` counts ``progress_step -
restored_step`` into ``paddle_ckpt_steps_lost_total``.

The entries are the reference's (``model/<key>``, ``opt/<key>``,
``rng/np_keys`` with ``extra["rng"]["np"]``) with one exception: the
reference stores its JAX device key as ``rng/device_key``; the port stores
each device stream of its generator as ``rng/torch/<device>`` with
``extra["rng"]["framework"] = "torch"``. Each package's manager restores
the model, optimizer and numpy state from the other's checkpoints; the
reference leaves its device RNG alone on a port checkpoint (it finds no
``rng/device_key``), and the port leaves its generator alone on a
reference checkpoint, with a warning. Optimizer accumulator keys embed
parameter names (``f"{name}_{accumulator}"``); the names the optimizer
keys its state by are recorded in order and remapped by position on
restore, so a model rebuilt under other names still maps each moment to
its parameter.

One live manager per checkpoint directory. Start-up sweeps the staging
debris of a predecessor killed mid-save.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..framework import random as _random
from ..framework.checkpoint import (AsyncCheckpointHandle,
                                    CheckpointCorruptError, _PinnedBuffer,
                                    list_checkpoints,
                                    load_checkpoint_extra, load_sharded,
                                    prune_checkpoints, quarantine_checkpoint,
                                    save_sharded, sweep_stale_staging)
from ..framework.flags import flag_value
from .preemption import PreemptionHandler

__all__ = ["CheckpointManager", "RestoreResult", "latest_checkpoint"]

_STEP_DIR_FMT = "step_{:08d}"
_PROGRESS_NAME = "PROGRESS"

_MODEL_PREFIX = "model/"
_OPT_PREFIX = "opt/"
_REF_RNG_KEY = "rng/device_key"     # the reference's JAX key
_RNG_TORCH_PREFIX = "rng/torch/"     # + device: the port's streams
_RNG_NP_KEYS = "rng/np_keys"


def _torch_of(v):
    """The torch tensor behind a Paddle tensor, or ``v`` itself."""
    data = getattr(v, "_data", None)
    return data if isinstance(data, torch.Tensor) else v


class RestoreResult:
    """What ``restore_latest`` recovered. ``step`` is the NEXT step to
    run (the saved global step); ``steps_lost`` is how far the dead
    process had progressed beyond it (from the PROGRESS marker)."""

    __slots__ = ("step", "epoch", "offset", "dataloader", "path",
                 "steps_lost", "restore_ms", "extra")

    def __init__(self, step, epoch, offset, dataloader, path, steps_lost,
                 restore_ms, extra):
        self.step = step
        self.epoch = epoch
        self.offset = offset
        self.dataloader = dataloader
        self.path = path
        self.steps_lost = steps_lost
        self.restore_ms = restore_ms
        self.extra = extra

    def __repr__(self):
        return (f"RestoreResult(step={self.step}, epoch={self.epoch}, "
                f"offset={self.offset}, steps_lost={self.steps_lost}, "
                f"path={self.path!r})")


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest committed checkpoint directory under ``directory`` (no
    integrity check — ``restore_latest`` does that), or None."""
    ckpts = list_checkpoints(directory)
    return ckpts[-1] if ckpts else None


class CheckpointManager:
    """Periodic, preemption-tolerant training-state checkpointing.

    Typical loop::

        mgr = CheckpointManager(dir, model=model, optimizer=opt,
                                save_interval_steps=100)
        res = mgr.restore_latest()
        start = res.step if res else 0
        mgr.install_preemption_handlers()
        for step in range(start, total):
            train_one_step(...)
            mgr.step(step + 1, epoch=epoch, offset=batch_idx)
        mgr.save(total, block=True, reason="final")
    """

    def __init__(self, directory: str, model=None, optimizer=None, *,
                 parameters: Optional[Dict[str, object]] = None,
                 keep: Optional[int] = None,
                 save_interval_steps: Optional[int] = None,
                 save_interval_s: Optional[float] = None,
                 async_save: Optional[bool] = None,
                 capture_rng: bool = True,
                 dataloader_state_fn: Optional[Callable[[], dict]] = None,
                 health_check: bool = True,
                 staleness_s: Optional[float] = None,
                 clean_stale_staging: bool = True,
                 now: Callable[[], float] = time.monotonic):
        if model is None and optimizer is None and parameters is None:
            raise ValueError(
                "CheckpointManager needs at least one of model=, "
                "optimizer=, parameters= (nothing to checkpoint)")
        self.directory = os.path.abspath(directory)
        self._model = model
        self._optimizer = optimizer
        self._parameters = dict(parameters) if parameters else None
        self.keep = int(flag_value("FLAGS_ckpt_keep")
                        if keep is None else keep)
        self.save_interval_steps = int(
            flag_value("FLAGS_ckpt_interval_steps")
            if save_interval_steps is None else save_interval_steps)
        self.save_interval_s = float(
            flag_value("FLAGS_ckpt_interval_s")
            if save_interval_s is None else save_interval_s)
        self.async_save = bool(flag_value("FLAGS_ckpt_async")
                               if async_save is None else async_save)
        self._capture_rng = capture_rng
        self._dataloader_state_fn = dataloader_state_fn
        self._now = now
        # re-entrant: a preemption's backstop save (preemption.py) can
        # interrupt the main thread while it holds the lock
        self._lock = threading.RLock()
        self._host_buffer = _PinnedBuffer()
        self._snapshotting = False
        self._inflight: Optional[AsyncCheckpointHandle] = None
        self._inflight_step = -1
        self._inflight_t0 = 0.0
        self._last_attempt_time: Optional[float] = None
        self._last_success_step = -1
        self._last_success_walltime: Optional[float] = None
        self._last_error: Optional[BaseException] = None
        self._last_seen = {"step": -1, "epoch": None, "offset": None,
                           "dataloader": None}
        self._preemption: Optional[PreemptionHandler] = None
        self._health_name: Optional[str] = None
        self._staleness_s = staleness_s

        os.makedirs(self.directory, exist_ok=True)
        if clean_stale_staging:
            sweep_stale_staging(self.directory)

        from ..observability.registry import default_registry
        reg = default_registry()
        self._m_last_step = reg.gauge(
            "paddle_ckpt_last_success_step",
            "global step of the last committed checkpoint")
        self._m_saves = reg.counter(
            "paddle_ckpt_saves_total",
            "checkpoint save attempts by outcome", ("result",))
        self._m_corrupt = reg.counter(
            "paddle_ckpt_corrupt_total",
            "checkpoint directories quarantined as corrupt on restore")
        self._m_steps_lost = reg.counter(
            "paddle_ckpt_steps_lost_total",
            "training steps re-run after restore because they "
            "post-dated the last committed checkpoint")
        if health_check:
            self.enable_health_check()

    # ----------------------------------------------------------- state
    def _capture(self, step: int, epoch, offset, dataloader_state,
                 reason: str):
        """(arrays, extra) for one checkpoint. Arrays stay device-side
        here — save_sharded host-snapshots them before returning."""
        arrays: Dict[str, object] = {}
        extra: Dict[str, object] = {
            "train": {"step": int(step),
                      "epoch": None if epoch is None else int(epoch),
                      "offset": None if offset is None else int(offset),
                      "wall_time": time.time(),
                      "reason": reason},
        }
        if self._model is not None:
            for k, v in self._model.state_dict().items():
                arrays[_MODEL_PREFIX + k] = v
        if self._parameters is not None:
            for k, v in self._parameters.items():
                arrays[_MODEL_PREFIX + k] = v
        if self._optimizer is not None:
            opt_scalars: Dict[str, object] = {}
            for k, v in self._optimizer.state_dict().items():
                if isinstance(_torch_of(v), torch.Tensor):
                    arrays[_OPT_PREFIX + k] = v
                else:  # "@step" int, "LR_Scheduler" dict: JSON-able
                    opt_scalars[k] = v
            extra["optimizer"] = opt_scalars
            # the names the accumulator keys embed, in parameter order, so
            # restore can remap onto an optimizer whose parameters carry
            # other names (same architecture)
            extra["optimizer_param_names"] = [
                self._optimizer._name(p)
                for p in self._optimizer._parameters or []]
        if self._capture_rng:
            gen = _random.default_generator().get_state()
            for dev, st in gen["states"].items():
                arrays[_RNG_TORCH_PREFIX + dev] = st
            np_state = np.random.get_state()
            arrays[_RNG_NP_KEYS] = np.asarray(np_state[1])
            extra["rng"] = {"framework": "torch", "seed": int(gen["seed"]),
                            "devices": sorted(gen["states"]),
                            "np": [np_state[0], int(np_state[2]),
                                   int(np_state[3]), float(np_state[4])]}
        if dataloader_state is None and self._dataloader_state_fn is not None:
            dataloader_state = self._dataloader_state_fn()
        if dataloader_state is not None:
            extra["dataloader"] = dataloader_state
        return arrays, extra

    @torch.no_grad()
    def _apply(self, loaded: Dict[str, torch.Tensor], extra: dict):
        loaded = {k: (v.full("cpu") if hasattr(v, "shards") else v)
                  for k, v in loaded.items()}
        if self._model is not None:
            model_sd = {k[len(_MODEL_PREFIX):]: v for k, v in loaded.items()
                        if k.startswith(_MODEL_PREFIX)}
            if model_sd:
                if hasattr(self._model, "set_state_dict"):  # nn.Layer
                    self._model.set_state_dict(model_sd)
                else:                                       # torch module
                    self._model.load_state_dict(model_sd)
        if self._parameters is not None:
            for k, p in self._parameters.items():
                v = loaded.get(_MODEL_PREFIX + k)
                if v is not None:
                    _torch_of(p).copy_(v)
        if self._optimizer is not None:
            opt_sd: Dict[str, object] = {
                k[len(_OPT_PREFIX):]: v for k, v in loaded.items()
                if k.startswith(_OPT_PREFIX)}
            opt_sd.update(extra.get("optimizer") or {})
            saved_names = extra.get("optimizer_param_names")
            cur = self._optimizer._parameters or []
            accums = getattr(self._optimizer, "_accum_names", [])
            if saved_names and len(saved_names) == len(cur):
                # remap accumulator keys from the saved names to the live
                # ones by position; exact `<param>_<accum>` matches only
                rename = {}
                for i, old in enumerate(saved_names):
                    cur_name = self._optimizer._name(cur[i])
                    if not old or not cur_name:
                        continue
                    for acc in accums:
                        rename[f"{old}_{acc}"] = f"{cur_name}_{acc}"
                opt_sd = {rename.get(k, k): v for k, v in opt_sd.items()}
            self._optimizer.set_state_dict(opt_sd)
        rng = extra.get("rng")
        if not self._capture_rng or rng is None:
            return
        np_meta = rng.get("np")
        if np_meta is not None and _RNG_NP_KEYS in loaded:
            keys = loaded[_RNG_NP_KEYS].numpy()
            np.random.set_state((np_meta[0], keys, int(np_meta[1]),
                                 int(np_meta[2]), float(np_meta[3])))
        if rng.get("framework") == "torch":
            # set_state creates each saved device's stream before it sets
            # it, so the first draw after a resume in a fresh process is
            # the one an uninterrupted run makes
            _random.default_generator().set_state({
                "seed": int(rng["seed"]),
                "states": {dev: loaded[_RNG_TORCH_PREFIX + dev]
                           for dev in rng.get("devices", [])
                           if _RNG_TORCH_PREFIX + dev in loaded}})
        elif _REF_RNG_KEY in loaded:
            warnings.warn(
                "restoring a checkpoint of the JAX package: its device RNG "
                "(a JAX key) has no counterpart in the port's generator, "
                "which is left as it is; the model, the optimizer and "
                "numpy's RNG were restored", RuntimeWarning, stacklevel=3)

    # ------------------------------------------------------------ save
    def step(self, step: int, epoch: Optional[int] = None,
             offset: Optional[int] = None,
             dataloader_state: Optional[dict] = None
             ) -> Optional[AsyncCheckpointHandle]:
        """Per-step hook: records progress (the steps-lost witness) and
        saves when the step/wall-clock cadence says so. Returns the
        in-flight handle when a save started."""
        with self._lock:
            self._last_seen = {"step": int(step), "epoch": epoch,
                               "offset": offset,
                               "dataloader": dataloader_state}
            handler = self._preemption
        self._write_progress(step)
        if handler is not None and handler.pending:
            # a preemption signal landed during this step: its final save
            # runs here, at the boundary, then the signal's disposition
            handler.run_pending()
            return None
        if not self._should_save(step):
            return None
        return self.save(step, epoch=epoch, offset=offset,
                         dataloader_state=dataloader_state)

    def _should_save(self, step: int) -> bool:
        if self.save_interval_steps > 0 and step > 0 and \
                step % self.save_interval_steps == 0:
            return True
        if self.save_interval_s > 0:
            with self._lock:
                last = self._last_attempt_time
            if last is None or self._now() - last >= self.save_interval_s:
                return True
        return False

    def _write_progress(self, step: int):
        """Tiny atomic marker: how far training actually got. Read back
        on restore to count steps lost to the kill. No fsync — it is a
        hint, and a torn replace is impossible."""
        import json
        tmp = os.path.join(self.directory,
                           f".{_PROGRESS_NAME}.tmp.{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump({"step": int(step), "wall_time": time.time()}, f)
            os.replace(tmp, os.path.join(self.directory, _PROGRESS_NAME))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _read_progress(self) -> Optional[int]:
        import json
        try:
            with open(os.path.join(self.directory, _PROGRESS_NAME)) as f:
                return int(json.load(f)["step"])
        except Exception:  # noqa: BLE001 - absent/torn marker: no info
            return None

    def save(self, step: int, epoch: Optional[int] = None,
             offset: Optional[int] = None,
             dataloader_state: Optional[dict] = None,
             block: bool = False, reason: str = "interval"
             ) -> Optional[AsyncCheckpointHandle]:
        """Checkpoint the full training state at ``step``. Async by
        default (manager policy): snapshots host-side now, commits on
        the writer thread. A previous in-flight save is awaited first —
        at most one writer at a time, and save errors are recorded (in
        metrics + ``last_error``) rather than raised, so a sick
        filesystem degrades durability, not training."""
        self.wait()  # errors from the previous save land in _last_error
        # goodput: only the SYNCHRONOUS part of a save (state capture +
        # device->host snapshot, plus the full write when blocking)
        # stalls training; the async writer thread runs alongside steps
        # and is deliberately not badput
        from ..observability.goodput import default_ledger
        ledger = default_ledger()
        ledger.begin("ckpt_save")
        try:
            arrays, extra = self._capture(step, epoch, offset,
                                          dataloader_state, reason)
            path = os.path.join(self.directory,
                                _STEP_DIR_FMT.format(int(step)))
            t0 = self._now()
            with self._lock:
                self._last_attempt_time = t0
            use_async = self.async_save and not block
            # a preemption's backstop save can land inside this save's
            # snapshot: it copies into memory of its own, not the buffer
            with self._lock:
                nested, self._snapshotting = self._snapshotting, True
            try:
                handle = save_sharded(
                    arrays, path, async_save=use_async, extra=extra,
                    host_buffer=None if nested else self._host_buffer)
            except Exception as e:  # noqa: BLE001 - record, don't kill
                self._record_save_result(step, error=e)  # training
                return None
            finally:
                if not nested:
                    with self._lock:
                        self._snapshotting = False
        finally:
            ledger.end()
        if handle is None:
            self._record_save_result(step, error=None)
            return None
        with self._lock:
            self._inflight = handle
            self._inflight_step = int(step)
        handle.add_done_callback(self._on_save_done)
        return handle

    def _on_save_done(self, handle: AsyncCheckpointHandle):
        with self._lock:
            if self._inflight is handle:
                self._inflight = None
            step = self._inflight_step
        self._record_save_result(step, error=handle.exception)

    def _record_save_result(self, step: int,
                            error: Optional[BaseException]):
        if error is not None:
            with self._lock:
                self._last_error = error
            self._m_saves.labels("error").inc()
            return
        with self._lock:
            self._last_error = None
            self._last_success_step = int(step)
            self._last_success_walltime = time.time()
        self._m_saves.labels("ok").inc()
        self._m_last_step.set(int(step))
        if self.keep > 0:
            prune_checkpoints(self.directory, self.keep)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until no save is in flight. Unlike the raw handle,
        never raises — writer errors are folded into save accounting by
        the done callback. Returns False if still in flight."""
        with self._lock:
            handle = self._inflight
        if handle is None:
            return True
        try:
            return handle.wait(timeout)
        except BaseException:  # noqa: BLE001 - already recorded by the
            return True        # done callback

    def final_save(self, deadline_s: Optional[float] = None,
                   reason: str = "preempt") -> bool:
        """Bounded-deadline last save (the preemption path). Saves the
        most recently seen step unless it is already committed; waits at
        most ``deadline_s`` for the commit. Returns True when the state
        is committed durable."""
        budget = float("inf") if deadline_s is None else float(deadline_s)
        t_end = self._now() + budget
        with self._lock:
            seen = dict(self._last_seen)
            done_step = self._last_success_step
            inflight = self._inflight
            inflight_step = self._inflight_step
        step = seen["step"]
        if step < 0:
            return False  # never stepped: nothing meaningful to save
        if done_step == step:
            return True   # already durable
        if inflight is not None and inflight_step == step:
            return inflight.wait(max(0.0, t_end - self._now())) and \
                inflight.exception is None
        handle = self.save(step, epoch=seen["epoch"],
                           offset=seen["offset"],
                           dataloader_state=seen["dataloader"],
                           reason=reason)
        if handle is None:  # sync save (or failed: last_error records it)
            with self._lock:
                return self._last_success_step == step
        ok = handle.wait(max(0.0, t_end - self._now()))
        return ok and handle.exception is None

    # --------------------------------------------------------- restore
    def restore_latest(self, mesh=None) -> Optional[RestoreResult]:
        """Load the newest intact checkpoint into the attached model,
        optimizer and RNG and return its metadata. Corrupt or partial
        directories are quarantined (``<dir>.corrupt-*``) and skipped:
        after any kill, some checkpoint loads or None is returned (the
        caller starts fresh). ``mesh`` places each entry with a recorded
        spec on it (``load_sharded(mesh=)``); the attached model's
        parameters are torch tensors, so the placed entries are gathered
        into them."""
        from ..observability.goodput import default_ledger
        ledger = default_ledger()
        self.wait()
        progress = self._read_progress()
        t0 = self._now()
        for path in reversed(list_checkpoints(self.directory)):
            try:
                with ledger.timed("ckpt_restore"):
                    loaded = load_sharded(path, mesh=mesh)
                    extra = load_checkpoint_extra(path) or {}
                    self._apply(loaded, extra)
            except CheckpointCorruptError:
                self._m_corrupt.inc()
                quarantine_checkpoint(path)
                continue
            train = extra.get("train") or {}
            step = int(train.get("step", -1))
            restore_ms = (self._now() - t0) * 1e3
            steps_lost = max(0, progress - step) \
                if (progress is not None and step >= 0) else 0
            if steps_lost:
                self._m_steps_lost.inc(steps_lost)
                # the next steps_lost step frames are replayed work —
                # MegaScale's preemption-recovery badput, not goodput
                ledger.arm_replay(steps_lost)
            with self._lock:
                self._last_success_step = step
                self._last_success_walltime = time.time()
            if step >= 0:
                self._m_last_step.set(step)
            return RestoreResult(
                step=step, epoch=train.get("epoch"),
                offset=train.get("offset"),
                dataloader=extra.get("dataloader"),
                path=path, steps_lost=steps_lost,
                restore_ms=restore_ms, extra=extra)
        return None

    # ------------------------------------------------------ preemption
    def install_preemption_handlers(self, signals=None,
                                    deadline_s: Optional[float] = None
                                    ) -> PreemptionHandler:
        """Wire SIGTERM/SIGINT to a bounded final save at the next step
        boundary (then chain to the previous handler, so default
        termination still happens)."""
        from .preemption import DEFAULT_PREEMPT_SIGNALS
        handler = PreemptionHandler(
            manager=self,
            signals=DEFAULT_PREEMPT_SIGNALS if signals is None else signals,
            deadline_s=deadline_s)
        handler.install()
        with self._lock:
            self._preemption = handler
        return handler

    @property
    def preempted(self) -> bool:
        """True once a preemption signal arrived (cooperative loops
        should drain and exit)."""
        with self._lock:
            handler = self._preemption
        return handler.requested() if handler is not None else False

    # ---------------------------------------------------------- health
    def enable_health_check(self, staleness_s: Optional[float] = None):
        """Register checkpoint staleness on the shared /healthz: fails
        when the last committed checkpoint is older than the threshold
        (or when the most recent save attempt errored)."""
        from ..observability.httpd import add_health_check
        if staleness_s is not None:
            self._staleness_s = float(staleness_s)
        name = f"checkpoint:{os.path.basename(self.directory)}"
        add_health_check(name, self._health)
        with self._lock:
            self._health_name = name

    def _staleness_threshold(self) -> float:
        if self._staleness_s:
            return float(self._staleness_s)
        flagged = float(flag_value("FLAGS_ckpt_staleness_s"))
        if flagged > 0:
            return flagged
        if self.save_interval_s > 0:
            return 3.0 * self.save_interval_s
        return 1800.0

    def _health(self):
        with self._lock:
            err = self._last_error
            last_wall = self._last_success_walltime
            last_step = self._last_success_step
        if err is not None:
            return False, {"last_error": repr(err),
                           "last_success_step": last_step}
        if last_wall is None:
            return True, {"state": "no checkpoint yet"}
        age = time.time() - last_wall
        limit = self._staleness_threshold()
        return age <= limit, {"last_success_step": last_step,
                              "age_s": round(age, 3),
                              "staleness_limit_s": round(limit, 3)}

    # --------------------------------------------------------- teardown
    @property
    def last_success_step(self) -> int:
        with self._lock:
            return self._last_success_step

    @property
    def last_error(self) -> Optional[BaseException]:
        with self._lock:
            return self._last_error

    def close(self):
        """Flush the in-flight save, run a pending preemption's final
        save, uninstall signal handlers, free the snapshot buffer and drop
        the health check."""
        self.wait()
        with self._lock:
            handler = self._preemption
            health_name = self._health_name
            self._health_name = None
        if handler is not None:
            handler.uninstall()     # runs a pending final save first
            with self._lock:
                self._preemption = None
        self.wait()
        self._host_buffer.free()
        if health_name is not None:
            from ..observability.httpd import remove_health_check
            remove_health_check(health_name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
