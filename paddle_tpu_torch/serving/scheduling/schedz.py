"""``/schedz``: the scheduler's JSON surface (the port of
``paddle_tpu/serving/scheduling/schedz.py``).

A per-process payload (``schedz_payload``) served by the telemetry
endpoint, and a merge (``merge_schedz_payloads``) that sums per-tenant
admission counters across processes. Admission controllers register into
a process-wide WeakSet (``register_controller``; the engine and the
server do it when given a ``scheduler=``), and fleet autoscalers into
another (``register_autoscaler``), so a dropped object leaves the payload by
itself.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict

__all__ = ["register_controller", "register_autoscaler",
           "schedz_payload", "merge_schedz_payloads"]

_LOCK = threading.Lock()
_CONTROLLERS: "weakref.WeakSet" = weakref.WeakSet()
_AUTOSCALERS: "weakref.WeakSet" = weakref.WeakSet()


def register_controller(controller) -> None:
    with _LOCK:
        _CONTROLLERS.add(controller)


def register_autoscaler(autoscaler) -> None:
    with _LOCK:
        _AUTOSCALERS.add(autoscaler)


def schedz_payload() -> dict:
    """The per-process ``/schedz`` document."""
    from ...observability.tracing import process_name
    with _LOCK:
        controllers = list(_CONTROLLERS)
        autoscalers = list(_AUTOSCALERS)
    return {
        "process": process_name(),
        "admission": {c.name: c.snapshot()
                      for c in sorted(controllers,
                                      key=lambda c: c.name)},
        "autoscalers": {a.name: a.snapshot()
                        for a in sorted(autoscalers,
                                        key=lambda a: a.name)},
    }


def merge_schedz_payloads(own: dict,
                          remotes: Dict[str, dict]) -> dict:
    """Router aggregation: the router's own document plus per-replica
    sub-documents, with per-tenant admission EVENT counts summed
    fleet-wide (``tenants`` — the "who is being shed" rollup)."""
    tenants: Dict[str, Dict[str, int]] = {}

    def _accumulate(doc: dict):
        for ctl in (doc.get("admission") or {}).values():
            for tenant, events in (ctl.get("events") or {}).items():
                agg = tenants.setdefault(tenant, {})
                for event, n in events.items():
                    agg[event] = agg.get(event, 0) + int(n)

    _accumulate(own)
    for doc in remotes.values():
        _accumulate(doc)
    return {
        "process": own.get("process"),
        "admission": own.get("admission", {}),
        "autoscalers": own.get("autoscalers", {}),
        "tenants": {t: dict(sorted(ev.items()))
                    for t, ev in sorted(tenants.items())},
        "replicas": {rid: doc for rid, doc in sorted(remotes.items())},
    }
