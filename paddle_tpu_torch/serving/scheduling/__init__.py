"""Multi-tenant admission control (the port of
``paddle_tpu/serving/scheduling``):

- ``policy``: tenant -> (rate, burst, weight, priority class) table, from
  ``FLAGS_sched_*`` or a hot-reloadable JSON policy file. The priority
  classes are ``realtime`` > ``standard`` > ``batch``; untagged requests
  map deterministically to the ``default`` tenant.
- ``admission``: per-tenant token buckets and weighted-fair queuing;
  typed per-tenant ``QuotaExceededError`` sheds instead of a global
  queue-full.
- ``schedz``: the ``/schedz`` JSON surface and, in ``metrics``, the
  ``paddle_sched_*`` metric families.
- ``autoscaler``: ``FleetAutoscaler`` follows the SLO monitor's burn-rate
  alert sinks, queue depth and decode occupancy and drives the fleet
  supervisor's ``scale_to(n)`` with hysteresis (``paddle_autoscale_*``
  metrics, ``/schedz``'s ``autoscalers``).

``InferenceServer(scheduler=)`` and ``GenerationServer(scheduler=)`` take
an ``AdmissionController``; the engine also parks lower-priority streams
under KV-page pressure and resumes them from their full history.
"""
from __future__ import annotations

from .admission import AdmissionController, TokenBucket, WeightedFairQueue
from .autoscaler import FleetAutoscaler
from .metrics import AutoscaleMetrics, SchedMetrics
from .policy import (DEFAULT_TENANT, PRIORITY_CLASSES, SchedulerPolicy,
                     TenantPolicy, normalize_tenant, priority_rank)
from .schedz import (merge_schedz_payloads, register_autoscaler,
                     register_controller, schedz_payload)

__all__ = [
    "AdmissionController", "TokenBucket", "WeightedFairQueue",
    "FleetAutoscaler", "SchedulerPolicy", "TenantPolicy",
    "SchedMetrics", "AutoscaleMetrics",
    "normalize_tenant", "priority_rank",
    "DEFAULT_TENANT", "PRIORITY_CLASSES",
    "schedz_payload", "merge_schedz_payloads",
    "register_controller", "register_autoscaler",
]
