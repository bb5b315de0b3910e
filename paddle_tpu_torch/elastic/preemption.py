"""Preemption signal handling, the SIGTERM -> final-save path: the port of
``paddle_tpu/elastic/preemption.py``.

Schedulers preempt a job with a SIGTERM and a short grace window before
the SIGKILL. ``PreemptionHandler`` turns that window into one last
committed checkpoint: it installs handlers for the configured signals,
sets a flag that cooperative loops poll (``requested()`` /
``CheckpointManager.preempted``), runs a bounded-deadline final save
through the attached manager, then chains to the handler installed before
it, so the process still ends with the conventional exit status.

Unlike the reference, the handler does not save where the signal lands.
CPython runs signal handlers on the main thread between bytecodes, and a
training step of the port is not one assignment: by the time the step's
Python returns, the batch has been drawn from the generator, the
optimizer's step count has moved and its in-place updates are queued on
the device. A save from inside the step would label that half-advanced
state with the previous step. So the handler only sets the flag, counts
the signal and marks the preemption pending; the manager runs the final
save at the next step boundary (its ``step()``, or ``close()`` after the
last step) and then chains. A loop that reaches no boundary within half
the deadline (an evaluation, a loop that never calls ``step()``) gets the
reference's behaviour as the backstop: a timer re-sends the signal, and
the handler saves where the main thread is. The save runs once under a
signal storm. The rest of the deadline, counted from the signal, bounds
the wait for the commit, not the device-to-host copy that starts the
save. ``boundary_wait_s``, ``final_save_s`` and ``final_save_ok`` record
the last preemption's seconds from the signal to its save, the save's
seconds, and whether it committed.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Iterable, Optional

from ..framework.flags import flag_value

__all__ = ["PreemptionHandler", "DEFAULT_PREEMPT_SIGNALS"]

DEFAULT_PREEMPT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def _preemption_counter():
    from ..observability.registry import default_registry
    return default_registry().counter(
        "paddle_ckpt_preemptions_total",
        "preemption signals handled by PreemptionHandler",
        ("signal",))


class PreemptionHandler:
    """Installable SIGTERM/SIGINT hook: flag + bounded final save at the
    next step boundary.

    ``install()`` must run on the main thread (CPython restriction on
    ``signal.signal``). ``uninstall()`` runs a pending preemption, then
    restores whatever handlers were there before. The handler is
    idempotent under signal storms: the final save runs once; repeat
    signals after it just re-chain."""

    def __init__(self, manager=None,
                 signals: Iterable[int] = DEFAULT_PREEMPT_SIGNALS,
                 deadline_s: Optional[float] = None,
                 chain: bool = True):
        self._manager = manager
        self._signals = tuple(signals)
        self._deadline_s = (flag_value("FLAGS_ckpt_preempt_deadline_s")
                            if deadline_s is None else float(deadline_s))
        # the wait for a step boundary: half the deadline, the rest is
        # the commit's
        self._wait_limit_s = self._deadline_s / 2
        self._chain = chain
        self._event = threading.Event()
        self._lock = threading.RLock()
        self._prev = {}
        self._installed = False
        self._saved_once = False
        # (signum, frame, perf_counter at the signal) until the boundary,
        # and the backstop's timer
        self._pending: Optional[tuple] = None
        self._backstop: Optional[threading.Timer] = None
        self.boundary_wait_s: Optional[float] = None
        self.final_save_s: Optional[float] = None
        self.final_save_ok: Optional[bool] = None

    # -------------------------------------------------------- install
    def install(self) -> "PreemptionHandler":
        with self._lock:
            if self._installed:
                return self
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
            self._installed = True
        return self

    def uninstall(self):
        self.run_pending()
        with self._lock:
            if not self._installed:
                return
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass  # not on main thread / already torn down
            self._prev = {}
            self._installed = False

    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def pending(self) -> bool:
        """A signal arrived and its final save waits for the boundary."""
        with self._lock:
            return self._pending is not None

    # --------------------------------------------------------- handle
    def _handle(self, signum, frame):
        self._event.set()
        try:
            _preemption_counter().labels(
                signal.Signals(signum).name).inc()
        except Exception:  # noqa: BLE001 - telemetry only
            pass
        with self._lock:
            pending = self._pending
            if pending is not None:
                if time.perf_counter() - pending[2] < self._wait_limit_s:
                    return      # one save waits for the boundary already
                expired = True  # the backstop: save where the loop is
            else:
                expired = False
                if not self._saved_once and self._manager is not None:
                    self._pending = (signum, frame, time.perf_counter())
                    self._backstop = threading.Timer(
                        self._wait_limit_s, os.kill,
                        (os.getpid(), signum))
                    self._backstop.daemon = True
                    self._backstop.start()
                    return
                self._saved_once = True
        if expired:
            self.run_pending()
        elif self._chain:
            self._chain_previous(signum, frame)

    def run_pending(self):
        """At a step boundary: run the pending final save, once, then
        chain to the previous handler (which ends the process under the
        default disposition). A no-op when no signal is pending."""
        with self._lock:
            pending, self._pending = self._pending, None
            if pending is None:
                return
            self._saved_once = True
            self._backstop.cancel()
        signum, frame, t_signal = pending
        t0 = time.perf_counter()
        self.boundary_wait_s = t0 - t_signal
        ok = False
        try:
            ok = self._manager.final_save(
                deadline_s=max(0.0, self._deadline_s - self.boundary_wait_s),
                reason="preempt")
        except Exception:  # noqa: BLE001 - a failing final save must
            pass           # not block process termination
        self.final_save_s = time.perf_counter() - t0
        self.final_save_ok = bool(ok)
        if self._chain:
            self._chain_previous(signum, frame)

    def _chain_previous(self, signum, frame):
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore the default disposition and re-deliver, so the
            # exit status is the conventional signal death (143/130)
            try:
                signal.signal(signum, signal.SIG_DFL)
            except (ValueError, OSError):
                return
            os.kill(os.getpid(), signum)
        # SIG_IGN / None: swallow, matching the prior disposition
