"""Admission control: per-tenant token buckets and weighted-fair queuing
(the port of ``paddle_tpu/serving/scheduling/admission.py``).

Two primitives, both clock-injected for deterministic tests:

``TokenBucket``: ``rate`` tokens/s refill into a bucket of depth
``burst``; ``try_acquire(n)`` spends n tokens or refuses atomically (no
partial spend, so admission composes with the KV allocator's
all-or-nothing reservations). ``rate`` 0 means unlimited.

``WeightedFairQueue``: start-time-fair virtual-clock WFQ (Goyal et al.):
each tenant's backlog is FIFO; a pop picks the eligible tenant with the
smallest virtual finish tag, where a tenant's next tag advances by
``cost / weight``, and an idle tenant's virtual time snaps forward to the
global clock on re-arrival, so sleeping never banks credit. Priority
classes sit above fairness: all queued ``realtime`` work is eligible
before any ``standard``, which precedes any ``batch``.

``AdmissionController`` glues them to a ``SchedulerPolicy``: one
``admit(tenant, cost)`` gate (raises the typed ``QuotaExceededError``)
and the WFQ pick the batcher and the generation engine's admission loop
use. All shared state is guarded by ``self._lock``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..request import QuotaExceededError
from .policy import SchedulerPolicy, normalize_tenant
from .metrics import SchedMetrics

__all__ = ["TokenBucket", "WeightedFairQueue", "AdmissionController"]


class TokenBucket:
    """Deterministic token bucket. Not self-locking — the owning
    controller serializes access (one lock for the whole admission
    decision, not one per bucket)."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        self.rate = max(0.0, float(rate))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst          # starts full: bursts admit
        self._t = float(now)

    def _refill(self, now: float):
        dt = max(0.0, now - self._t)
        self._t = now
        if self.rate > 0.0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def try_acquire(self, n: float, now: float) -> bool:
        """Spend ``n`` tokens at time ``now`` or refuse (no partial
        spend). rate 0 = unlimited (always admits, bucket untouched)."""
        if self.rate <= 0.0:
            return True
        self._refill(now)
        if self.tokens + 1e-9 >= n:
            self.tokens -= n
            return True
        return False

    def available(self, now: float) -> float:
        if self.rate <= 0.0:
            return float("inf")
        self._refill(now)
        return self.tokens


class _TenantLane:
    """Per-tenant WFQ state: FIFO backlog + virtual finish tag."""

    __slots__ = ("items", "finish")

    def __init__(self):
        self.items: List[Tuple[object, float]] = []  # (item, cost)
        self.finish = 0.0


class WeightedFairQueue:
    """Start-time-fair queuing across tenants, priority classes
    strictly first. Not self-locking (the owner's admission lock
    already serializes push/pop with the rest of the decision)."""

    def __init__(self, policy: SchedulerPolicy):
        self.policy = policy
        self._lanes: Dict[str, _TenantLane] = {}
        self._vtime = 0.0                  # global virtual clock

    def __len__(self) -> int:
        return sum(len(lane.items) for lane in self._lanes.values())

    def depths(self) -> Dict[str, int]:
        return {t: len(lane.items)
                for t, lane in self._lanes.items() if lane.items}

    def push(self, item, tenant: Optional[str], cost: float = 1.0):
        t = normalize_tenant(tenant)
        lane = self._lanes.get(t)
        if lane is None:
            lane = self._lanes[t] = _TenantLane()
        if not lane.items:
            # idle tenant re-arrives: no banked credit from sleeping
            lane.finish = max(lane.finish, self._vtime)
        lane.items.append((item, max(1e-9, float(cost))))

    def pop(self):
        """Dequeue the next item by (priority class, virtual finish
        tag); None when empty."""
        best_t, best_key = None, None
        for t, lane in self._lanes.items():
            if not lane.items:
                continue
            rank = self.policy.lookup(t).rank
            key = (rank, lane.finish, t)
            if best_key is None or key < best_key:
                best_t, best_key = t, key
        if best_t is None:
            return None
        lane = self._lanes[best_t]
        item, cost = lane.items.pop(0)
        weight = self.policy.lookup(best_t).weight
        self._vtime = max(self._vtime, lane.finish)
        lane.finish = max(lane.finish, self._vtime) + cost / weight
        return item

    def drain(self) -> List[object]:
        out = []
        for lane in self._lanes.values():
            out.extend(item for item, _ in lane.items)
            lane.items.clear()
        return out


class AdmissionController:
    """One admission point's quota + fairness state.

    ``admit(tenant, cost)`` debits the tenant's bucket and raises
    ``QuotaExceededError`` (typed, per-tenant — it rides the codec
    status mapping across the fleet wire) when the envelope is
    exhausted. ``select(candidates)`` is the WFQ pick the engine's
    admission loop uses over its request queue.
    """

    def __init__(self, policy: Optional[SchedulerPolicy] = None,
                 name: str = "server", now=None, metrics=None):
        import time as _time
        self.policy = policy or SchedulerPolicy()
        self.name = name
        self._now = now or _time.monotonic
        self.metrics = metrics if metrics is not None \
            else SchedMetrics(name)
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._wfq = WeightedFairQueue(self.policy)

    # ------------------------------------------------------ quota
    def _bucket(self, tenant: str, now: float) -> TokenBucket:
        pol = self.policy.lookup(tenant)
        b = self._buckets.get(tenant)
        if b is None or (b.rate, b.burst) != (pol.rate, pol.burst):
            # new tenant, or its envelope was hot-reloaded
            b = TokenBucket(pol.rate, pol.burst, now)
            self._buckets[tenant] = b
        return b

    def try_admit(self, tenant: Optional[str],
                  cost: float = 1.0) -> bool:
        """Debit ``cost`` tokens from the tenant's bucket; False =
        shed this tenant (others unaffected)."""
        self.policy.maybe_reload()
        t = normalize_tenant(tenant)
        now = self._now()
        with self._lock:
            b = self._bucket(t, now)
            ok = b.try_acquire(cost, now)
            avail = b.available(now)
        if self.metrics is not None:
            self.metrics.count(t, "admitted" if ok else "shed_quota")
            self.metrics.set_tokens(
                t, 0.0 if avail == float("inf") else avail)
        return ok

    def admit(self, tenant: Optional[str], cost: float = 1.0) -> str:
        """``try_admit`` raising the typed per-tenant shed; returns
        the normalized tenant name on admission."""
        t = normalize_tenant(tenant)
        if not self.try_admit(t, cost):
            pol = self.policy.lookup(t)
            raise QuotaExceededError(
                f"tenant {t!r} exceeded its quota "
                f"({pol.rate:g} tokens/s, burst {pol.burst:g}); "
                f"other tenants are unaffected", tenant=t)
        return t

    def tokens_available(self, tenant: Optional[str]) -> float:
        t = normalize_tenant(tenant)
        now = self._now()
        with self._lock:
            return self._bucket(t, now).available(now)

    # ------------------------------------------------------ fairness
    def select(self, candidates) -> Optional[int]:
        """Weighted-fair pick over a sequence of queued requests:
        returns the INDEX of the request to admit next, or None when
        empty. Candidates expose ``.tenant`` (missing/None maps to
        default) and an optional ``.cost`` (defaults 1.0); FIFO within
        a tenant is preserved by construction (the scan takes each
        tenant's first occurrence).

        Stateful: each pick advances the chosen tenant's virtual
        finish tag, so repeated calls interleave tenants by weight
        instead of re-picking the same head."""
        heads: Dict[str, int] = {}
        order: List[str] = []
        for i, req in enumerate(candidates):
            t = normalize_tenant(getattr(req, "tenant", None))
            if t not in heads:
                heads[t] = i
                order.append(t)
        if not heads:
            return None
        with self._lock:
            best_t, best_key = None, None
            for t in order:
                pol = self.policy.lookup(t)
                lane = self._wfq._lanes.get(t)
                finish = lane.finish if lane is not None else 0.0
                finish = max(finish, self._wfq._vtime)
                key = (pol.rank, finish, t)
                if best_key is None or key < best_key:
                    best_t, best_key = t, key
            idx = heads[best_t]
            req = candidates[idx]
            cost = max(1e-9, float(getattr(req, "cost", None)
                                   or 1.0))
            pol = self.policy.lookup(best_t)
            lane = self._wfq._lanes.get(best_t)
            if lane is None:
                lane = self._wfq._lanes[best_t] = _TenantLane()
            self._wfq._vtime = max(self._wfq._vtime, best_key[1])
            lane.finish = best_key[1] + cost / pol.weight
        return idx

    # ------------------------------------------------------ export
    def snapshot(self) -> dict:
        now = self._now()
        with self._lock:
            buckets = {
                t: {"tokens": (None if b.rate <= 0.0
                               else round(b.available(now), 3)),
                    "rate": b.rate, "burst": b.burst}
                for t, b in sorted(self._buckets.items())}
        out = {"name": self.name, "buckets": buckets,
               "policy": self.policy.snapshot()}
        if self.metrics is not None:
            out["events"] = self.metrics.snapshot()
        return out
