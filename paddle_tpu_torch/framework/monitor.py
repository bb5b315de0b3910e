"""Named stat registry (the port of ``paddle_tpu/framework/monitor.py``; the
reference framework's ``platform/monitor.cc`` STAT_ADD/STAT_RESET counters).

The stats are one label set on the ``paddle_monitor_stat_total`` counter of
``observability.registry.default_registry()``, as in the reference; the
flat-int API (``stat_add``/``stat_get``/``stat_reset``) is its surface.
"""
from __future__ import annotations

from typing import Optional

from ..observability.registry import default_registry

__all__ = ["stat_add", "stat_get", "stat_reset"]

_counter = default_registry().counter(
    "paddle_monitor_stat_total",
    "framework STAT_ADD int64 counters (platform/monitor.cc analog)",
    ("name",))


def stat_add(name: str, value: int = 1) -> int:
    return int(_counter.labels(name=name).inc(int(value)))


def stat_get(name: str) -> int:
    child = _counter.get(name=name)
    return int(child.value) if child is not None else 0


def stat_reset(name: Optional[str] = None):
    if name is None:
        _counter.clear()
    else:
        _counter.remove(name=name)

