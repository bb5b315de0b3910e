"""Metric families of the scheduler (the port of
``paddle_tpu/serving/scheduling/metrics.py``).

``SchedMetrics`` is the per-admission-point view (``paddle_sched_*``,
labelled ``server`` and ``tenant``), on the default registry so
``/metrics`` sees it with no extra wiring. The reference's
``AutoscaleMetrics`` acts for the fleet autoscaler and waits with it
(ROADMAP queue 1 item 5b, the fleet).
"""
from __future__ import annotations

import threading
from typing import Dict

from ...observability._unported import not_ported

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


AutoscaleMetrics = not_ported(
    "AutoscaleMetrics", "item 5b (the fleet, with scheduling/autoscaler.py)")
