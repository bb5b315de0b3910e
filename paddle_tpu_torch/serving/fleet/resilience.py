"""Serving-resilience primitives of the fleet (the port of
``paddle_tpu/serving/fleet/resilience.py``): deadlines, breakers, backoff
and the device-wedge watchdog.

- ``Deadline`` — one request's absolute time budget on the monotonic
  clock, carried across hops as what is left (``remaining_ms``), so a
  worker can reject already-expired work before it reaches the device.
- ``CircuitBreaker`` — per-replica rolling outcome window with the closed
  -> open -> half-open -> closed state machine; a latency threshold makes
  slow-but-alive count as failure, and half-open admits one probe at a
  time.
- ``retry_backoff_ms`` — exponential backoff with full jitter, drawn from
  an explicit ``random.Random`` when one is given (the router keeps its
  own), and ``latency_quantile`` — the nearest-rank quantile the hedging
  trigger reads.
- ``ReplicaWedgedError`` — the typed error a wedge turns into, carried by
  the fleet codec.
- ``WedgeMonitor`` / ``WedgeWatchdog`` — dispatch-level hang detection:
  backends bracket device work with ``begin()``/``end()``; the watchdog
  thread fires once when the oldest open dispatch exceeds
  ``FLAGS_fleet_wedge_timeout_ms``.

Standard library only, every object lock-guarded.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

__all__ = ["Deadline", "CircuitBreaker", "ReplicaWedgedError",
           "WedgeMonitor", "WedgeWatchdog", "retry_backoff_ms",
           "latency_quantile"]


def _flag(name, default):
    from ...framework.flags import flag_value
    try:
        v = flag_value(name)
    except KeyError:
        return default
    return v


class ReplicaWedgedError(RuntimeError):
    """The replica's device wedged (a dispatch exceeded the wedge
    timeout): the request did not complete and the replica is
    restarting. Distinct from QueueFullError (backpressure) and
    ServerClosedError (clean shutdown) so callers and the router can
    react differently."""


# ---------------------------------------------------------------- deadline
class Deadline:
    """An absolute per-request time budget on the monotonic clock.

    Wire form is RELATIVE (``remaining_ms``) because wall clocks of
    router and worker processes are not comparable; each hop
    reconstructs its own absolute deadline from what is left when the
    payload arrives. ``None`` budget = no deadline (infinite)."""

    __slots__ = ("_at",)

    def __init__(self, budget_ms: Optional[float]):
        self._at = (time.monotonic() + float(budget_ms) / 1e3
                    if budget_ms else None)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    @property
    def bounded(self) -> bool:
        return self._at is not None

    def remaining_ms(self) -> Optional[float]:
        """Milliseconds left (may be negative once expired); None for
        an unbounded deadline."""
        if self._at is None:
            return None
        return (self._at - time.monotonic()) * 1e3

    def expired(self) -> bool:
        return self._at is not None and time.monotonic() > self._at

    def clamp_ms(self, ms: float) -> float:
        """``ms`` bounded by what is left of the budget (>= 0)."""
        rem = self.remaining_ms()
        if rem is None:
            return ms
        return max(0.0, min(ms, rem))


# ---------------------------------------------------------------- backoff
def retry_backoff_ms(attempt: int, base_ms: float, max_ms: float,
                     rng: Optional[random.Random] = None) -> float:
    """Exponential backoff with FULL jitter: uniform over
    [0, min(max, base * 2^attempt)]. Full jitter decorrelates the
    fleet's retries — under a brownout every un-jittered client
    re-dispatches on the same schedule and the retry wave re-creates
    the overload it is retrying around."""
    cap = min(float(max_ms), float(base_ms) * (2.0 ** max(0, attempt)))
    r = rng.random() if rng is not None else random.random()
    return cap * r


def latency_quantile(samples, q: float) -> Optional[float]:
    """Nearest-rank quantile of an iterable of latencies (ms); None
    when empty."""
    xs = sorted(samples)
    if not xs:
        return None
    idx = min(len(xs) - 1, max(0, int(q * len(xs))))
    return float(xs[idx])


# ---------------------------------------------------------------- breaker
class CircuitBreaker:
    """Per-replica health memory: a rolling window of request outcomes
    driving closed/open/half-open admission.

    - record(ok, latency_ms): every finished dispatch reports here. A
      success slower than ``latency_threshold_ms`` (when > 0) counts
      as a FAILURE — the slow-but-alive signal readiness misses.
    - allow(): whether a new dispatch may go to this replica. Closed:
      yes. Open: no until ``open_ms`` elapsed, then the breaker moves
      to half-open and admits exactly ONE in-flight probe. Half-open:
      only the probe slot.
    - The probe's outcome closes (success) or re-opens (failure) the
      breaker; ``on_transition(old, new)`` fires outside the lock for
      metrics.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, window: Optional[int] = None,
                 failure_ratio: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 open_ms: Optional[float] = None,
                 latency_threshold_ms: Optional[float] = None,
                 on_transition: Optional[Callable] = None):
        self.window = int(window if window is not None
                          else _flag("FLAGS_fleet_breaker_window", 16))
        self.failure_ratio = float(
            failure_ratio if failure_ratio is not None
            else _flag("FLAGS_fleet_breaker_failure_ratio", 0.5))
        self.min_samples = int(
            min_samples if min_samples is not None
            else _flag("FLAGS_fleet_breaker_min_samples", 4))
        self.open_ms = float(
            open_ms if open_ms is not None
            else _flag("FLAGS_fleet_breaker_open_ms", 1000.0))
        self.latency_threshold_ms = float(
            latency_threshold_ms if latency_threshold_ms is not None
            else _flag("FLAGS_fleet_breaker_latency_ms", 0.0))
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._outcomes: "deque[bool]" = deque(maxlen=max(1, self.window))
        self._latencies: "deque[float]" = deque(
            maxlen=max(1, self.window))
        self._opened_at = 0.0
        self._probe_inflight = False
        self._opens = 0

    # ---- inspection ----
    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    @property
    def opens(self) -> int:
        with self._lock:
            return self._opens

    def latency_window(self) -> List[float]:
        with self._lock:
            return list(self._latencies)

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._outcomes)
            fails = sum(1 for ok in self._outcomes if not ok)
            return {"state": self._effective_state(),
                    "samples": n, "failures": fails,
                    "failure_ratio": (fails / n) if n else 0.0,
                    "opens": self._opens,
                    "open_remaining_ms": max(
                        0.0, (self._opened_at + self.open_ms / 1e3
                              - time.monotonic()) * 1e3)
                    if self._state == self.OPEN else 0.0}

    # ---- state machine ----
    def _effective_state(self) -> str:
        """Lock held. OPEN lazily decays to HALF_OPEN after the
        cooldown (no timer thread)."""
        if self._state == self.OPEN and \
                time.monotonic() - self._opened_at >= self.open_ms / 1e3:
            self._state = self.HALF_OPEN
            self._probe_inflight = False
        return self._state

    def allow(self) -> bool:
        """May a dispatch go to this replica now? In half-open this
        CONSUMES the single probe slot — callers that end up not
        dispatching must record an outcome or call ``release_probe``."""
        with self._lock:
            state = self._effective_state()
            if state == self.CLOSED:
                return True
            if state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def release_probe(self):
        """Return an unused half-open probe slot (the caller took
        ``allow()`` but never dispatched)."""
        with self._lock:
            self._probe_inflight = False

    def record(self, ok: bool, latency_ms: Optional[float] = None):
        effective_ok = bool(ok)
        if effective_ok and latency_ms is not None and \
                self.latency_threshold_ms > 0 and \
                latency_ms > self.latency_threshold_ms:
            effective_ok = False    # slow-but-alive counts as failure
        transition: Optional[Tuple[str, str]] = None
        with self._lock:
            state = self._effective_state()
            if latency_ms is not None and ok:
                self._latencies.append(float(latency_ms))
            self._outcomes.append(effective_ok)
            if state == self.HALF_OPEN:
                self._probe_inflight = False
                if effective_ok:
                    self._state = self.CLOSED
                    self._outcomes.clear()
                    transition = (self.HALF_OPEN, self.CLOSED)
                else:
                    self._state = self.OPEN
                    self._opened_at = time.monotonic()
                    self._opens += 1
                    transition = (self.HALF_OPEN, self.OPEN)
            elif state == self.CLOSED:
                n = len(self._outcomes)
                fails = sum(1 for o in self._outcomes if not o)
                if n >= self.min_samples and \
                        fails / n >= self.failure_ratio:
                    self._state = self.OPEN
                    self._opened_at = time.monotonic()
                    self._opens += 1
                    transition = (self.CLOSED, self.OPEN)
        if transition is not None and self.on_transition is not None:
            try:
                self.on_transition(*transition)
            except Exception:  # noqa: BLE001 - metrics must not break
                pass           # the data plane

    def force_open(self):
        """Open immediately (the watchdog's shortcut when a wedge is
        detected by other means)."""
        transition = None
        with self._lock:
            if self._state != self.OPEN:
                transition = (self._effective_state(), self.OPEN)
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._opens += 1
        if transition is not None and self.on_transition is not None:
            try:
                self.on_transition(*transition)
            except Exception:  # noqa: BLE001 - as above
                pass


# ---------------------------------------------------------------- wedge
class WedgeMonitor:
    """In-flight dispatch ledger a backend brackets device work with:

        token = monitor.begin()
        try:    ... device dispatch ...
        finally: monitor.end(token)

    ``oldest_age_ms()`` is what the watchdog polls: the age of the
    longest-running still-open dispatch (0 when idle). A dispatch that
    never calls ``end`` makes the age grow without bound — exactly the
    wedge signature."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self._seq = 0
        self._completed = 0

    def begin(self) -> int:
        with self._lock:
            self._seq += 1
            token = self._seq
            self._inflight[token] = time.monotonic()
            return token

    def end(self, token: int):
        with self._lock:
            if self._inflight.pop(token, None) is not None:
                self._completed += 1

    def oldest_age_ms(self) -> float:
        with self._lock:
            if not self._inflight:
                return 0.0
            return (time.monotonic() - min(self._inflight.values())) \
                * 1e3

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    @property
    def completed(self) -> int:
        with self._lock:
            return self._completed


class WedgeWatchdog:
    """Heartbeat thread over a ``WedgeMonitor``: when the oldest
    in-flight dispatch exceeds ``timeout_ms``, the watchdog (once)
    marks itself wedged, calls ``on_wedge()`` — the worker's hook to
    flip /readyz, fail waiting requests with ``ReplicaWedgedError``
    and ask for a restart — and keeps the wedged flag up so readiness
    stays red until the process is replaced. ``timeout_ms <= 0``
    disables the thread entirely (construction is still cheap)."""

    def __init__(self, monitor: WedgeMonitor, *,
                 timeout_ms: Optional[float] = None,
                 poll_interval_s: float = 0.05,
                 on_wedge: Optional[Callable] = None,
                 name: str = "replica"):
        self.monitor = monitor
        self.timeout_ms = float(
            timeout_ms if timeout_ms is not None
            else _flag("FLAGS_fleet_wedge_timeout_ms", 0.0))
        self.poll_interval_s = float(poll_interval_s)
        self.on_wedge = on_wedge
        self.name = name
        self._wedged = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wedge_count = 0

    @property
    def enabled(self) -> bool:
        return self.timeout_ms > 0

    @property
    def wedged(self) -> bool:
        return self._wedged.is_set()

    @property
    def wedge_count(self) -> int:
        return self._wedge_count

    def start(self) -> "WedgeWatchdog":
        if self.enabled and (self._thread is None
                             or not self._thread.is_alive()):
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"fleet-wedge-watchdog-{self.name}")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() and \
                t is not threading.current_thread():
            t.join(timeout=5)

    def _loop(self):
        while not self._stop.wait(self.poll_interval_s):
            if self._wedged.is_set():
                continue        # one firing per process lifetime
            if self.monitor.oldest_age_ms() > self.timeout_ms:
                self._fire()

    def _fire(self):
        self._wedged.set()
        self._wedge_count += 1
        if self.on_wedge is not None:
            try:
                self.on_wedge()
            except Exception:  # noqa: BLE001 - the watchdog must not
                pass           # die on a broken recovery hook
