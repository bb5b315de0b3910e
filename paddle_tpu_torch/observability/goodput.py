"""Goodput ledger: the port of ``paddle_tpu/observability/goodput.py``,
wall-clock accounting of a training run.

MegaScale (Jiang et al., 2024) makes the case that what keeps large
training jobs operable is an *accounting identity*: every second of
wall-clock is either productive step time or a typed category of badput,
and the categories sum to elapsed time. This module is that accountant for
one process, as the reference's:

- **Categories** (``CATEGORIES``): ``step`` (productive step time, fed by
  ``jit.TrainStep`` and ``TrainingTelemetryCallback``), ``compile`` (the
  kernel library's build, ``observability/runtime.py``, and each compile-
  cache miss's measured first dispatch, ``compile_cache/cache.py``, where
  the reference feeds its JAX compiles), ``ckpt_save`` / ``ckpt_restore``
  (the synchronous part
  of ``CheckpointManager`` saves, and restores; the async writer is off the
  critical path and is not badput), ``data_stall`` (the fit loop's gap
  between batches), ``recovery`` (steps re-run after a preemption restore,
  armed by ``CheckpointManager.restore_latest``'s steps-lost count), and
  derived ``idle`` (elapsed minus everything attributed).
- **Frames, not raw adds**: attribution nests. A ``timed("step")`` frame
  that contains a recording records only ``elapsed - claimed`` to its own
  category. Frames are per thread; recordings from another thread are
  plain adds.
- **Exposure**: ``paddle_goodput_seconds_total{category=}`` counters (idle
  synced at scrape and report time, so the scraped categories also sum to
  elapsed), a ``paddle_goodput_fraction`` gauge, ``report()`` (the
  ``/goodputz`` JSON, whose ``accounting`` block checks the identity
  within ``FLAGS_goodput_tolerance``), and ``goodputz_payload()``, which
  adds the continuous step profiler's summary.

Time is injected (``now=``) so the identity is testable with a
deterministic clock. The port keeps its own copy: it imports nothing of
the JAX package.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from .registry import MetricRegistry, default_registry

__all__ = [
    "GoodputLedger", "default_ledger", "set_default_ledger",
    "record", "timed", "goodput_report", "goodputz_payload",
    "CATEGORIES",
]

# "idle" is derived (elapsed - attributed), never recorded directly.
CATEGORIES = ("step", "compile", "ckpt_save", "ckpt_restore",
              "data_stall", "recovery")
IDLE = "idle"


def _tolerance() -> float:
    try:
        from ..framework.flags import flag_value
        return float(flag_value("FLAGS_goodput_tolerance"))
    except Exception:  # noqa: BLE001 - flags may not be registered yet
        return 0.02


class _Frame:
    """One open attribution interval on a thread's frame stack."""

    __slots__ = ("category", "t0", "claimed")

    def __init__(self, category: str, t0: float):
        self.category = category
        self.t0 = t0
        self.claimed = 0.0


class GoodputLedger:
    """Process-wide wall-clock accountant. Thread-safe; the frame
    stack is thread-local so concurrent recorders (serving threads,
    the checkpoint writer) attribute independently."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 now: Callable[[], float] = time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t0: Optional[float] = None
        self._acc = {c: 0.0 for c in CATEGORIES}
        self._idle_exported = 0.0
        self._replay_steps = 0
        reg = registry or default_registry()
        self._c_seconds = reg.counter(
            "paddle_goodput_seconds_total",
            "wall-clock seconds attributed per goodput category "
            "(step = productive; the rest are typed badput; idle is "
            "synced so scraped categories sum to elapsed)",
            ("category",))
        self._g_fraction = reg.gauge(
            "paddle_goodput_fraction",
            "productive (step) fraction of elapsed wall-clock since "
            "the ledger started")
        # label children cached: the step frame close is on the hot path
        self._children = {c: self._c_seconds.labels(category=c)
                          for c in CATEGORIES + (IDLE,)}
        reg.register_collector(self._collect, name="goodput_ledger")

    # ------------------------------------------------------- lifecycle
    def start(self, t: Optional[float] = None) -> "GoodputLedger":
        """Mark the run start. Idempotent; the first recording
        auto-starts the clock if this was never called."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self._now() if t is None else float(t)
        return self

    def reset(self):
        with self._lock:
            self._t0 = None
            self._acc = {c: 0.0 for c in CATEGORIES}
            self._idle_exported = 0.0
            self._replay_steps = 0

    @property
    def started(self) -> bool:
        with self._lock:
            return self._t0 is not None

    @property
    def started_at(self) -> Optional[float]:
        """The ledger clock's reading at the run start (None before)."""
        with self._lock:
            return self._t0

    # ------------------------------------------------------- recording
    def record(self, category: str, seconds: float):
        """Attribute ``seconds`` to ``category``. Inside an open frame
        on this thread the seconds are also *claimed* from that frame,
        so the frame's own category gets only the unclaimed remainder
        — the no-double-count rule."""
        if category not in self._acc:
            raise ValueError(
                f"unknown goodput category {category!r} "
                f"(have {CATEGORIES})")
        seconds = max(0.0, float(seconds))
        self.start()
        with self._lock:
            self._acc[category] += seconds
        self._children[category].inc(seconds)
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1].claimed += seconds

    def begin(self, category: str) -> None:
        """Open an attribution frame on this thread (pair with
        ``end()``; ``timed()`` is the context-manager form)."""
        self.start()
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(_Frame(category, self._now()))

    def end(self) -> float:
        """Close the innermost frame: its category receives the
        frame's elapsed minus whatever nested recordings claimed; the
        full elapsed propagates to the parent frame's claim. Returns
        the frame's wall elapsed seconds."""
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return 0.0
        frame = stack.pop()
        elapsed = max(0.0, self._now() - frame.t0)
        own = max(0.0, elapsed - frame.claimed)
        category = frame.category
        if category == "step":
            category = self._consume_replay() or category
        with self._lock:
            self._acc[category] += own
        self._children[category].inc(own)
        if stack:
            stack[-1].claimed += elapsed
        return elapsed

    @contextmanager
    def timed(self, category: str):
        self.begin(category)
        try:
            yield self
        finally:
            self.end()

    # ------------------------------------------------------- recovery
    def arm_replay(self, n_steps: int):
        """Restore path: the next ``n_steps`` step frames are re-runs
        of work lost to the preemption — they land in ``recovery``,
        not ``step`` (MegaScale's replay badput)."""
        with self._lock:
            self._replay_steps += max(0, int(n_steps))

    def _consume_replay(self) -> Optional[str]:
        with self._lock:
            if self._replay_steps > 0:
                self._replay_steps -= 1
                return "recovery"
        return None

    # ------------------------------------------------------- reporting
    def report(self, tolerance: Optional[float] = None) -> dict:
        """The ``/goodputz`` accounting document. Categories (plus
        derived idle) sum to elapsed wall-clock; ``accounting.closes``
        asserts it within ``tolerance`` (attribution can only overrun
        elapsed via overlapping recorders — concurrent threads each
        claiming wall time — which the report surfaces rather than
        hides)."""
        tol = _tolerance() if tolerance is None else float(tolerance)
        with self._lock:
            t0 = self._t0
            acc = dict(self._acc)
        elapsed = max(0.0, self._now() - t0) if t0 is not None else 0.0
        attributed = sum(acc.values())
        idle = max(0.0, elapsed - attributed)
        overlap = max(0.0, attributed - elapsed)
        categories = {c: round(v, 6) for c, v in acc.items()}
        categories[IDLE] = round(idle, 6)
        total = attributed + idle
        err = abs(total - elapsed) / elapsed if elapsed > 0 else 0.0
        goodput = acc["step"] / elapsed if elapsed > 0 else 0.0
        self._sync_idle(idle)
        self._g_fraction.set(goodput)
        return {
            "started": t0 is not None,
            "elapsed_s": round(elapsed, 6),
            "categories_s": categories,
            "goodput_fraction": round(goodput, 6),
            "badput_fraction": round(
                (attributed - acc["step"]) / elapsed
                if elapsed > 0 else 0.0, 6),
            "replay_steps_pending": self._replay_steps,
            "accounting": {
                "sum_s": round(total, 6),
                "error_fraction": round(err, 6),
                "overlap_s": round(overlap, 6),
                "tolerance": tol,
                "closes": err <= tol,
            },
        }

    def _sync_idle(self, idle: float):
        """Keep the exported idle counter monotone and equal to the
        derived idle, so a scrape's categories also sum to elapsed."""
        with self._lock:
            delta = idle - self._idle_exported
            if delta <= 0:
                return
            self._idle_exported = idle
        self._children[IDLE].inc(delta)

    def _collect(self, _reg):
        """Scrape-time collector: refresh the fraction gauge and the
        idle counter just before exposition."""
        if self.started:
            self.report()


# ------------------------------------------------------------- default
_default_lock = threading.Lock()
_default: Optional[GoodputLedger] = None


def default_ledger() -> GoodputLedger:
    """The process-wide ledger every built-in recorder reports into
    (TrainStep, the fit telemetry callback, CheckpointManager)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = GoodputLedger()
        return _default


def set_default_ledger(ledger: Optional[GoodputLedger]
                       ) -> Optional[GoodputLedger]:
    """Swap the process-wide ledger (tests; ``None`` resets to a fresh
    one on next use). Returns the previous ledger."""
    global _default
    with _default_lock:
        prev, _default = _default, ledger
    return prev


def record(category: str, seconds: float):
    """Module-level convenience onto the default ledger."""
    default_ledger().record(category, seconds)


@contextmanager
def timed(category: str):
    with default_ledger().timed(category):
        yield


def goodput_report(tolerance: Optional[float] = None) -> dict:
    return default_ledger().report(tolerance=tolerance)


def goodputz_payload() -> dict:
    """The ``/goodputz`` document: the accounting report plus the
    continuous step profiler's live summary."""
    from . import stepprof
    return {
        "goodput": goodput_report(),
        "steps": stepprof.default_profiler().summary(),
    }
