"""Metric families of the scheduler (the port of
``paddle_tpu/serving/scheduling/metrics.py``).

``SchedMetrics`` is the per-admission-point view (``paddle_sched_*``,
labelled ``server`` and ``tenant``), ``AutoscaleMetrics`` the fleet
autoscaler's control-loop view (``paddle_autoscale_*``); both live on the
default registry so ``/metrics`` sees them with no extra wiring.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["SchedMetrics", "AutoscaleMetrics"]


class SchedMetrics:
    """Per-tenant admission accounting for one admission point.

    - ``paddle_sched_requests_total{server,tenant,event}`` —
      admitted / shed_quota / preempted / parked / resumed per tenant
    - ``paddle_sched_tokens_available{server,tenant}`` — current
      token-bucket level (the throttling headroom signal)
    - ``paddle_sched_queue_depth{server,tenant}`` — queued requests
      per tenant at this admission point
    """

    _EVENTS = ("admitted", "shed_quota", "preempted", "parked",
               "resumed")

    def __init__(self, name: str, registry=None):
        from ...observability.registry import default_registry
        reg = registry or default_registry()
        self.name = name
        self._lock = threading.Lock()
        self._f_events = reg.counter(
            "paddle_sched_requests_total",
            "per-tenant admission lifecycle events",
            ("server", "tenant", "event"))
        self._f_tokens = reg.gauge(
            "paddle_sched_tokens_available",
            "token-bucket level per tenant (admission headroom)",
            ("server", "tenant"))
        self._f_depth = reg.gauge(
            "paddle_sched_queue_depth",
            "queued requests per tenant at this admission point",
            ("server", "tenant"))
        for fam in (self._f_events, self._f_tokens, self._f_depth):
            fam.clear(server=name)
        self._counts: Dict[tuple, int] = {}

    def count(self, tenant: str, event: str, n: int = 1):
        self._f_events.labels(server=self.name, tenant=tenant,
                              event=event).inc(n)
        with self._lock:
            key = (tenant, event)
            self._counts[key] = self._counts.get(key, 0) + n

    def set_tokens(self, tenant: str, tokens: float):
        self._f_tokens.labels(server=self.name, tenant=tenant).set(
            round(float(tokens), 3))

    def set_depth(self, tenant: str, depth: int):
        self._f_depth.labels(server=self.name, tenant=tenant).set(
            int(depth))

    def snapshot(self) -> dict:
        """Per-tenant event counts, nested tenant -> event -> n."""
        with self._lock:
            counts = dict(self._counts)
        out: Dict[str, Dict[str, int]] = {}
        for (tenant, event), n in sorted(counts.items()):
            out.setdefault(tenant, {})[event] = n
        return out


class AutoscaleMetrics:
    """Control-loop accounting:

    - ``paddle_autoscale_decisions_total{fleet,direction,reason}``
    - ``paddle_autoscale_target_replicas{fleet}`` — last target passed
      to ``scale_to``
    - ``paddle_autoscale_signal{fleet,signal}`` — the inputs the last
      evaluation saw (queue_depth, occupancy, fast_burn, slow_burn)
    """

    def __init__(self, name: str, registry=None):
        from ...observability.registry import default_registry
        reg = registry or default_registry()
        self.name = name
        self._f_decisions = reg.counter(
            "paddle_autoscale_decisions_total",
            "scale decisions by direction and triggering reason",
            ("fleet", "direction", "reason"))
        self._f_target = reg.gauge(
            "paddle_autoscale_target_replicas",
            "replica count last requested from the supervisor",
            ("fleet",))
        self._f_signal = reg.gauge(
            "paddle_autoscale_signal",
            "inputs seen by the last autoscaler evaluation",
            ("fleet", "signal"))
        for fam in (self._f_decisions, self._f_target,
                    self._f_signal):
            fam.clear(fleet=name)
        self._g_target = self._f_target.labels(fleet=name)

    def count_decision(self, direction: str, reason: str):
        self._f_decisions.labels(fleet=self.name, direction=direction,
                                 reason=reason).inc()

    def set_target(self, n: int):
        self._g_target.set(int(n))

    def set_signal(self, signal: str, value: float):
        self._f_signal.labels(fleet=self.name, signal=signal).set(
            round(float(value), 4))
