"""Router-side fleet metrics and the merged multi-replica /metrics view
(the port of ``paddle_tpu/serving/fleet/metrics.py``).

``FleetMetrics`` puts the router's counters on the port's registry as
``paddle_fleet_*`` families, so the router process's own telemetry
endpoint exposes them alongside everything else:

- ``paddle_fleet_requests_total{router,event}`` — routed / completed /
  failed / shed request counts (shed = rejected after the retry budget)
- ``paddle_fleet_retries_total{router,reason}`` — re-dispatches after a
  replica shed (queue_full) or refused/unreachable dispatch
  (unavailable)
- ``paddle_fleet_sheds_total{router,replica}`` — per-replica 429s seen
- ``paddle_fleet_outstanding{router,replica}`` — in-flight requests per
  replica (the least-outstanding routing signal, exported)
- ``paddle_fleet_replicas{router,state}`` — ready / live / draining /
  known replica counts
- ``paddle_fleet_replica_restarts_total{fleet}`` — supervisor respawns
- ``paddle_fleet_swaps_total{router,event}`` — rolling weight-swap
  lifecycle (replica_reloaded / completed / failed)
- ``paddle_fleet_request_ms{router}`` — router-observed end-to-end
  batch latency
- ``paddle_fleet_breaker_transitions_total{router,replica,state}`` —
  circuit-breaker state entries (open / half_open / closed) per
  replica
- ``paddle_fleet_breaker_open{router,replica}`` — 1 while the
  replica's breaker is open or half-open (shedding), else 0
- ``paddle_fleet_hedges_total{router,event}`` — hedged-request
  accounting: fired (a hedge dispatched), won (the hedge answered
  first), wasted (the loser completed anyway — duplicate execution
  paid for nothing)
- ``paddle_fleet_deadline_rejects_total{router,where}`` — requests
  rejected on an exhausted deadline budget, by the hop that caught
  it (router / worker)

``merge_prometheus_texts`` builds the fleet-wide scrape: each
replica's own /metrics text re-labeled with ``replica="<id>"`` and
concatenated under de-duplicated HELP/TYPE headers, so one scrape of
the router shows every replica's serving counters without a discovery
config.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["FleetMetrics", "merge_prometheus_texts"]

_EVENTS = ("routed", "completed", "failed", "shed")
_SWAP_EVENTS = ("replica_reloaded", "completed", "failed")
_HEDGE_EVENTS = ("fired", "won", "wasted")


class FleetMetrics:
    """Typed fleet metric families plus a JSON snapshot. The families
    live on the default registry unless ``registry`` names another."""

    def __init__(self, name: str, window: int = 4096, registry=None):
        from ...observability.registry import (PercentileWindow,
                                               default_registry)
        self.name = name
        self._lock = threading.Lock()
        reg = registry or default_registry()
        self._f_events = reg.counter(
            "paddle_fleet_requests_total",
            "router request lifecycle events", ("router", "event"))
        self._f_retries = reg.counter(
            "paddle_fleet_retries_total",
            "batch re-dispatches after a replica shed or refused",
            ("router", "reason"))
        self._f_sheds = reg.counter(
            "paddle_fleet_sheds_total",
            "QueueFullError (HTTP 429) sheds observed per replica",
            ("router", "replica"))
        self._f_outstanding = reg.gauge(
            "paddle_fleet_outstanding",
            "in-flight requests per replica (least-outstanding "
            "routing signal)", ("router", "replica"))
        self._f_replicas = reg.gauge(
            "paddle_fleet_replicas",
            "replica counts by state", ("router", "state"))
        self._f_restarts = reg.counter(
            "paddle_fleet_replica_restarts_total",
            "replica processes respawned by the supervisor after an "
            "unexpected exit", ("fleet",))
        self._f_swaps = reg.counter(
            "paddle_fleet_swaps_total",
            "rolling weight-swap lifecycle events", ("router", "event"))
        self._f_lat = reg.histogram(
            "paddle_fleet_request_ms",
            "router-observed end-to-end batch latency", ("router",))
        self._f_breaker = reg.counter(
            "paddle_fleet_breaker_transitions_total",
            "circuit-breaker state entries per replica",
            ("router", "replica", "state"))
        self._f_breaker_open = reg.gauge(
            "paddle_fleet_breaker_open",
            "1 while the replica's breaker sheds (open/half-open)",
            ("router", "replica"))
        self._f_hedges = reg.counter(
            "paddle_fleet_hedges_total",
            "hedged-request accounting (fired / won / wasted "
            "duplicate execution)", ("router", "event"))
        self._f_deadline = reg.counter(
            "paddle_fleet_deadline_rejects_total",
            "requests rejected on an exhausted deadline budget, by "
            "the hop that caught it", ("router", "where"))
        for fam in (self._f_events, self._f_retries, self._f_sheds,
                    self._f_outstanding, self._f_replicas,
                    self._f_swaps, self._f_lat, self._f_breaker,
                    self._f_breaker_open, self._f_hedges,
                    self._f_deadline):
            fam.clear(router=name)
        self._events = {e: self._f_events.labels(router=name, event=e)
                        for e in _EVENTS}
        self._retries = {r: self._f_retries.labels(router=name,
                                                   reason=r)
                         for r in ("queue_full", "unavailable")}
        self._swaps = {e: self._f_swaps.labels(router=name, event=e)
                       for e in _SWAP_EVENTS}
        self._states = {s: self._f_replicas.labels(router=name,
                                                   state=s)
                        for s in ("known", "ready", "live",
                                  "draining")}
        self._h_lat = self._f_lat.labels(router=name)
        self._hedges = {e: self._f_hedges.labels(router=name, event=e)
                        for e in _HEDGE_EVENTS}
        self._deadline = {w: self._f_deadline.labels(router=name,
                                                     where=w)
                          for w in ("router", "worker")}
        self._w_lat = PercentileWindow(int(window))

    def count(self, event: str, n: int = 1):
        self._events[event].inc(n)

    def count_retry(self, reason: str):
        self._retries[reason].inc()

    def count_shed(self, replica: str):
        self._f_sheds.labels(router=self.name, replica=replica).inc()

    def count_hedge(self, event: str, n: int = 1):
        self._hedges[event].inc(n)

    def count_deadline_reject(self, where: str, n: int = 1):
        self._deadline[where].inc(n)

    def count_breaker_transition(self, replica: str, state: str):
        self._f_breaker.labels(router=self.name, replica=replica,
                               state=state).inc()
        self._f_breaker_open.labels(
            router=self.name, replica=replica).set(
            0 if state == "closed" else 1)

    def count_restart(self):
        self._f_restarts.labels(fleet=self.name).inc()

    def count_swap(self, event: str):
        self._swaps[event].inc()

    def set_outstanding(self, replica: str, n: int):
        self._f_outstanding.labels(router=self.name,
                                   replica=replica).set(n)

    def drop_replica(self, replica: str):
        self._f_outstanding.clear(router=self.name, replica=replica)
        self._f_sheds.clear(router=self.name, replica=replica)
        self._f_breaker.clear(router=self.name, replica=replica)
        self._f_breaker_open.clear(router=self.name, replica=replica)

    def set_replica_states(self, known: int, ready: int, live: int,
                           draining: int):
        self._states["known"].set(known)
        self._states["ready"].set(ready)
        self._states["live"].set(live)
        self._states["draining"].set(draining)

    def observe_latency(self, ms: float):
        with self._lock:
            self._w_lat.observe(float(ms))
        self._h_lat.observe(float(ms))

    def snapshot(self) -> dict:
        with self._lock:
            lat = self._w_lat.snapshot()
        return {
            "router": self.name,
            "counters": {e: int(c.value)
                         for e, c in self._events.items()},
            "retries": {r: int(c.value)
                        for r, c in self._retries.items()},
            "swaps": {e: int(c.value)
                      for e, c in self._swaps.items()},
            "replicas": {s: int(g.value)
                         for s, g in self._states.items()},
            "restarts": int(
                self._f_restarts.labels(fleet=self.name).value),
            "hedges": {e: int(c.value)
                       for e, c in self._hedges.items()},
            "deadline_rejects": {w: int(c.value)
                                 for w, c in self._deadline.items()},
            "request_ms": lat,
        }


def merge_prometheus_texts(texts: Dict[str, str],
                           own: Optional[str] = None) -> str:
    """Merge per-replica Prometheus exposition texts into one scrape:
    every sample line gains a ``replica="<id>"`` label, and repeated
    ``# HELP`` / ``# TYPE`` headers (each replica declares the same
    families) are kept once. ``own`` (the router's local exposition)
    is prepended untouched."""
    out: List[str] = []
    seen_headers = set()
    if own:
        out.append(own.rstrip("\n"))
        for line in own.splitlines():
            if line.startswith("#"):
                seen_headers.add(line)
    for replica_id, text in sorted(texts.items()):
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                if line not in seen_headers:
                    seen_headers.add(line)
                    out.append(line)
                continue
            # sample line: name{labels} value  |  name value
            name, _, rest = line.partition(" ")
            if "{" in name:
                head, _, tail = name.partition("{")
                labeled = f'{head}{{replica="{replica_id}",{tail}'
            else:
                labeled = f'{name}{{replica="{replica_id}"}}'
            out.append(f"{labeled} {rest}" if rest else labeled)
    return "\n".join(out) + "\n"
