"""FleetAutoscaler (the port of
``paddle_tpu/serving/scheduling/autoscaler.py``): the control loop that
calls the fleet supervisor's ``scale_to``.

- **Scale OUT** when the fast-burn page fires (an SLO burning at page
  severity), the queue backs up past ``queue_high``, or decode occupancy
  passes ``occupancy_high`` — one step of ``step`` replicas, capped at
  ``max_replicas``.
- **Scale IN** only when it is quiet: no burn-rate rule firing (fast or
  slow), queue and occupancy under half their limits, for
  ``scale_in_quiet_s`` — one replica at a time, floored at
  ``min_replicas``.
- **Hysteresis**: a ``cooldown_s`` between scale actions in either
  direction, plus the asymmetric quiet requirement, so an oscillating load
  cannot flap the fleet.

The clock is injectable (``now=``) and ``evaluate()`` is one pure step;
``start()`` runs it on a daemon thread every ``interval_s``. Decisions
(time, old -> new, reason, signals) are kept in a bounded log that
``snapshot()`` returns (``/schedz`` lists a registered autoscaler under
``autoscalers``: ``schedz.register_autoscaler``) and counted on the
``paddle_autoscale_*`` metrics.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional

from .metrics import AutoscaleMetrics

__all__ = ["FleetAutoscaler"]


def _flag(name, default):
    from ...framework.flags import flag_value
    try:
        return flag_value(name)
    except KeyError:
        return default


class FleetAutoscaler:
    """Drives ``supervisor.scale_to(n)`` from SLO burn-rate alerts +
    queue depth + decode occupancy.

    ``monitor`` is an ``SLOMonitor`` (or None): the autoscaler
    registers an alert sink named ``autoscaler-<name>`` and tracks
    which burn rules are currently firing. ``queue_depth_fn`` /
    ``occupancy_fn`` are pull signals (callables returning a number;
    None disables that signal).
    """

    def __init__(self, supervisor, *, monitor=None,
                 queue_depth_fn: Optional[Callable[[], float]] = None,
                 occupancy_fn: Optional[Callable[[], float]] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 scale_in_quiet_s: Optional[float] = None,
                 queue_high: Optional[float] = None,
                 occupancy_high: Optional[float] = None,
                 step: int = 1, interval_s: Optional[float] = None,
                 now=None, name: str = "fleet", metrics=None,
                 decision_log: int = 256):
        import time as _time
        self.supervisor = supervisor
        self.monitor = monitor
        self.queue_depth_fn = queue_depth_fn
        self.occupancy_fn = occupancy_fn
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else _flag("FLAGS_autoscale_min_replicas", 1))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _flag("FLAGS_autoscale_max_replicas", 8))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _flag("FLAGS_autoscale_cooldown_s", 30.0))
        self.scale_in_quiet_s = float(
            scale_in_quiet_s if scale_in_quiet_s is not None
            else _flag("FLAGS_autoscale_scale_in_quiet_s", 120.0))
        self.queue_high = float(
            queue_high if queue_high is not None
            else _flag("FLAGS_autoscale_queue_high", 16.0))
        self.occupancy_high = float(
            occupancy_high if occupancy_high is not None
            else _flag("FLAGS_autoscale_occupancy_high", 0.85))
        self.step = max(1, int(step))
        self.interval_s = float(
            interval_s if interval_s is not None
            else _flag("FLAGS_autoscale_interval_s", 5.0))
        self.name = name
        self.metrics = metrics if metrics is not None \
            else AutoscaleMetrics(name)
        self._now = now or _time.monotonic
        self._lock = threading.Lock()
        self._firing: Dict[tuple, dict] = {}   # (slo, rule) -> alert
        self._last_action_t: Optional[float] = None
        self._quiet_since: Optional[float] = self._now()
        self._decisions: deque = deque(maxlen=int(decision_log))
        self._evaluations = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sink_name = f"autoscaler-{name}"
        if monitor is not None:
            monitor.add_alert_sink(self._sink_name, self._on_alert)

    # ------------------------------------------------------ signals
    def _on_alert(self, alert: dict):
        """SLOMonitor sink: called on firing-state transitions."""
        key = (alert.get("slo"), alert.get("rule"))
        with self._lock:
            if alert.get("firing"):
                self._firing[key] = dict(alert)
            else:
                self._firing.pop(key, None)

    def _burn_state(self):
        with self._lock:
            fast = any(r == "fast_burn" for _, r in self._firing)
            slow = any(r == "slow_burn" for _, r in self._firing)
        return fast, slow

    def _pull(self, fn) -> float:
        if fn is None:
            return 0.0
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 - a dead signal reads 0, the
            return 0.0     # loop must outlive its sensors

    # ------------------------------------------------------ the loop
    def evaluate(self) -> Optional[dict]:
        """One control step: read signals, maybe scale. Returns the
        decision record when a scale action was taken, else None."""
        now = self._now()
        fast, slow = self._burn_state()
        depth = self._pull(self.queue_depth_fn)
        occ = self._pull(self.occupancy_fn)
        current = len(self.supervisor.replica_ids)
        m = self.metrics
        if m is not None:
            m.set_signal("fast_burn", 1.0 if fast else 0.0)
            m.set_signal("slow_burn", 1.0 if slow else 0.0)
            m.set_signal("queue_depth", depth)
            m.set_signal("occupancy", occ)
        busy = fast or slow or depth > self.queue_high / 2.0 \
            or occ > self.occupancy_high / 2.0
        with self._lock:
            self._evaluations += 1
            if busy:
                self._quiet_since = None
            elif self._quiet_since is None:
                self._quiet_since = now
            quiet_since = self._quiet_since
            last_action = self._last_action_t
        in_cooldown = last_action is not None and \
            now - last_action < self.cooldown_s

        target, reason = current, None
        if fast:
            target, reason = current + self.step, "fast_burn_page"
        elif depth > self.queue_high:
            target, reason = current + self.step, "queue_depth"
        elif occ > self.occupancy_high:
            target, reason = current + self.step, "occupancy"
        elif (not fast and not slow and quiet_since is not None
              and now - quiet_since >= self.scale_in_quiet_s):
            target, reason = current - 1, "slow_burn_quiet"
        target = max(self.min_replicas,
                     min(self.max_replicas, target))
        if target == current or reason is None:
            return None
        if in_cooldown:
            return None
        direction = "out" if target > current else "in"
        self.supervisor.scale_to(target)
        decision = {
            "t": round(now, 3), "from": current, "to": target,
            "direction": direction, "reason": reason,
            "signals": {"fast_burn": fast, "slow_burn": slow,
                        "queue_depth": round(depth, 2),
                        "occupancy": round(occ, 3)},
        }
        with self._lock:
            self._last_action_t = now
            if direction == "in":
                # a scale-in resets the quiet clock: the smaller fleet
                # must prove itself quiet again before shrinking more
                self._quiet_since = now
            self._decisions.append(decision)
        if m is not None:
            m.count_decision(direction, reason)
            m.set_target(target)
        return decision

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 - the control loop must
                pass           # survive a transient supervisor error

    def start(self) -> "FleetAutoscaler":
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop,
                    name=f"autoscaler-{self.name}", daemon=True)
                self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(2.0)
        if self.monitor is not None:
            try:
                self.monitor.remove_alert_sink(self._sink_name)
            except Exception:  # noqa: BLE001 - sink may be gone
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------ export
    def snapshot(self) -> dict:
        with self._lock:
            firing = [{"slo": s, "rule": r}
                      for (s, r) in sorted(self._firing)]
            decisions = list(self._decisions)[-32:]
            evaluations = self._evaluations
            last_action = self._last_action_t
        return {
            "name": self.name,
            "replicas": len(self.supervisor.replica_ids),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_s": self.cooldown_s,
            "scale_in_quiet_s": self.scale_in_quiet_s,
            "queue_high": self.queue_high,
            "occupancy_high": self.occupancy_high,
            "evaluations": evaluations,
            "last_action_t": last_action,
            "firing": firing,
            "decisions": decisions,
        }
