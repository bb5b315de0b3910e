"""Tenant policy: who may burn how much, at which priority (the port of
``paddle_tpu/serving/scheduling/policy.py``).

A policy maps tenant ids to ``TenantPolicy`` records: token-bucket
rate/burst, a weighted-fair-queuing weight, and a priority class:

- ``realtime``: interactive traffic; never preempted, admitted first.
- ``standard``: the default class.
- ``batch``:    offline bulk; first to be parked under KV-page pressure,
                last in admission order.

Configuration comes from ``FLAGS_sched_*`` (the default tenant's
envelope) plus an optional JSON policy file (``FLAGS_sched_policy_file``)
that is hot-reloadable: the file's mtime is re-checked at most once per
``reload_interval_s``. File format::

    {
      "tenants": {
        "acme":  {"rate": 200, "burst": 400, "weight": 4,
                  "priority": "realtime"},
        "crawl": {"rate": 50, "burst": 50, "weight": 1,
                  "priority": "batch"}
      },
      "default": {"rate": 0, "burst": 64, "weight": 1,
                  "priority": "standard"}
    }

``rate`` is tokens/second (0 = unlimited), ``burst`` the bucket depth.
Requests without a tenant tag map deterministically to the ``default``
tenant (``normalize_tenant``). The clock is injected (``now=``).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

__all__ = ["PRIORITY_CLASSES", "DEFAULT_TENANT", "normalize_tenant",
           "priority_rank", "TenantPolicy", "SchedulerPolicy"]

# lower rank = more important; admission prefers low, eviction hits
# high. Unknown class names clamp to "standard".
PRIORITY_CLASSES = {"realtime": 0, "standard": 1, "batch": 2}
_RANK_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}
DEFAULT_TENANT = "default"

_TENANT_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789._-")


def normalize_tenant(tenant: Optional[str]) -> str:
    """The one untagged-tenant mapping every ingress form shares: None,
    empty, non-string, over-long, or non-identifier values all collapse
    to ``default``, deterministically."""
    if not isinstance(tenant, str):
        return DEFAULT_TENANT
    t = tenant.strip()
    if not t or len(t) > 64 or not all(c in _TENANT_OK for c in t):
        return DEFAULT_TENANT
    return t


def priority_rank(priority: Optional[str]) -> int:
    """Class name -> rank; unknown/None -> standard."""
    return PRIORITY_CLASSES.get(priority or "",
                                PRIORITY_CLASSES["standard"])


def _flag(name, default):
    from ...framework.flags import flag_value
    try:
        return flag_value(name)
    except KeyError:
        return default


class TenantPolicy:
    """One tenant's envelope (plain data)."""

    __slots__ = ("tenant", "rate", "burst", "weight", "priority")

    def __init__(self, tenant: str, rate: float = 0.0,
                 burst: float = 64.0, weight: float = 1.0,
                 priority: str = "standard"):
        self.tenant = tenant
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self.weight = max(1e-6, float(weight))
        self.priority = priority if priority in PRIORITY_CLASSES \
            else "standard"

    @property
    def rank(self) -> int:
        return PRIORITY_CLASSES[self.priority]

    def as_dict(self) -> dict:
        return {"rate": self.rate, "burst": self.burst,
                "weight": self.weight, "priority": self.priority}


class SchedulerPolicy:
    """The resolved tenant table + its hot-reload machinery.

    ``lookup(tenant)`` is the only read path; unknown tenants inherit
    the default envelope (with their own name, so metrics stay
    per-tenant). Thread-safe: the table swaps atomically under
    ``_lock`` on reload; lookups copy nothing.
    """

    def __init__(self, path: Optional[str] = None,
                 default: Optional[TenantPolicy] = None,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 reload_interval_s: float = 1.0, now=None):
        import time as _time
        self._now = now or _time.monotonic
        self._lock = threading.Lock()
        self.path = path if path is not None \
            else (_flag("FLAGS_sched_policy_file", "") or None)
        self.reload_interval_s = float(reload_interval_s)
        self._default = default or TenantPolicy(
            DEFAULT_TENANT,
            rate=_flag("FLAGS_sched_default_rate", 0.0),
            burst=_flag("FLAGS_sched_default_burst", 64.0),
            weight=_flag("FLAGS_sched_default_weight", 1.0),
            priority=_flag("FLAGS_sched_default_priority", "standard"))
        self._tenants: Dict[str, TenantPolicy] = dict(tenants or {})
        self._mtime: Optional[float] = None
        self._last_check = -1e18
        self._reloads = 0
        self._reload_errors = 0
        self._last_error = ""
        if self.path:
            self.reload()

    # ------------------------------------------------------ reload
    def reload(self) -> bool:
        """Force-load the policy file now. Returns True when a table
        was (re)applied; a missing or malformed file keeps the last
        good table and counts a reload error."""
        path = self.path
        if not path:
            return False
        try:
            mtime = os.stat(path).st_mtime
            with open(path) as f:
                doc = json.load(f)
            default = doc.get("default")
            tenants = {
                normalize_tenant(name): TenantPolicy(
                    normalize_tenant(name), **spec)
                for name, spec in (doc.get("tenants") or {}).items()}
        except (OSError, ValueError, TypeError) as e:
            with self._lock:
                self._reload_errors += 1
                self._last_error = f"{type(e).__name__}: {e}"
            return False
        with self._lock:
            if default is not None:
                self._default = TenantPolicy(DEFAULT_TENANT, **default)
            self._tenants = tenants
            self._mtime = mtime
            self._reloads += 1
        return True

    def maybe_reload(self):
        """mtime-gated hot reload; stat() at most once per
        ``reload_interval_s`` so the admission hot path never pays a
        syscall per request."""
        if not self.path:
            return
        now = self._now()
        with self._lock:
            if now - self._last_check < self.reload_interval_s:
                return
            self._last_check = now
            mtime = self._mtime
        try:
            cur = os.stat(self.path).st_mtime
        except OSError:
            return
        if cur != mtime:
            self.reload()

    # ------------------------------------------------------ reads
    def lookup(self, tenant: Optional[str]) -> TenantPolicy:
        name = normalize_tenant(tenant)
        with self._lock:
            pol = self._tenants.get(name)
            default = self._default
        if pol is not None:
            return pol
        if name == DEFAULT_TENANT:
            return default
        # unknown tenant: default envelope under its own name
        return TenantPolicy(name, rate=default.rate,
                            burst=default.burst, weight=default.weight,
                            priority=default.priority)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "path": self.path, "reloads": self._reloads,
                "reload_errors": self._reload_errors,
                "last_error": self._last_error,
                "default": self._default.as_dict(),
                "tenants": {name: p.as_dict()
                            for name, p in sorted(
                                self._tenants.items())},
            }
