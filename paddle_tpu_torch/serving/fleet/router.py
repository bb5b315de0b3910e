"""Front-end router (the port of ``paddle_tpu/serving/fleet/router.py``):
readiness-routed load balancing over N replicas.

``FleetRouter`` is the fleet's single client-facing surface. It keeps
a live view of the replica set (seeded explicitly or discovered from a
``ReplicaSupervisor``), polls every replica's ``/readyz`` on a cadence
(``FLAGS_fleet_health_interval_ms``), and dispatches:

- ``submit`` / ``submit_many`` — the batch is encoded once (codec.py)
  and forwarded WHOLE to one replica, preserving the replica-side
  dynamic batcher's coalescing. Replica choice is least-outstanding
  (the queue-depth signal a heterogeneous fleet needs; with equal
  queues it degrades to round-robin). A shed (HTTP 429 =
  ``QueueFullError``) or an unreachable/not-ready replica triggers a
  retry on a DIFFERENT replica up to ``FLAGS_fleet_retries`` times,
  then the batch fails with ``QueueFullError`` — load shedding
  surfaces to the caller exactly like a single server's backpressure.
- ``submit_generate`` — a streaming decode request: tokens are
  re-emitted into the caller's ``StreamingFuture`` as the replica's
  ndjson stream produces them.

Routing is on READINESS, not liveness: a replica that is alive but
still running its warmup receives nothing; the moment its
``/readyz`` flips, traffic flows. In-flight requests on a replica
that dies mid-request fail (only those — no silent cross-replica
retry of possibly-executed work); requests never yet sent to a
replica are always safe to re-route.

``swap_weights`` is the rolling hot swap: one replica at a time is
drained (marked unroutable, outstanding waited to zero), told to
``/reload`` the version-stamped artifact (the replica warms the
replacement before it swaps), verified ready again, and returned to
rotation — zero downtime, zero failed in-flight requests, fleet-wide.

The merged views (``/metrics?merged=1``, ``/tracez``, ``/sloz``,
``/schedz``) fan out to every live replica and stitch the answers with
the operations plane's helpers; ``/goodputz``, ``/execz``, ``/profilez``
and ``/numericsz`` answer 501 naming their ROADMAP items, as the port's
telemetry endpoint does.

Resilience layer (resilience.py):

- every request carries an absolute DEADLINE budget: the router
  deducts elapsed time per hop, stamps the remaining milliseconds
  onto the wire (codec deadline trailer / generate JSON field) so the
  worker can reject already-expired work before it ever reaches the
  device, and fails locally once the budget is gone instead of
  burning retries on a dead request;
- each replica has a CIRCUIT BREAKER fed by every dispatch outcome
  (errors, sheds, and — with ``FLAGS_fleet_breaker_latency_ms`` —
  slow-but-alive responses): an open breaker drains the replica even
  while its ``/readyz`` stays green, a half-open probe re-admits it;
- retries use EXPONENTIAL BACKOFF WITH FULL JITTER
  (``FLAGS_fleet_retry_backoff_*``) instead of the fixed immediate
  re-dispatch loop;
- ``submit``/``submit_many`` (idempotent) optionally HEDGE: when the
  primary dispatch exceeds the replica's rolling latency quantile, a
  duplicate fires to a second replica and the first response wins
  (``paddle_fleet_hedges_total`` accounts fired/won/wasted);
  ``submit_generate`` never hedges — a token stream is not
  idempotent.
"""
from __future__ import annotations

import concurrent.futures
import http.client
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ...observability import tracing
from ...observability.httpd import UNPORTED_ENDPOINTS
from ..generation.engine import StreamingFuture
from ..request import (DeadlineExceededError, QueueFullError,
                       ServerClosedError)
from . import codec
from .metrics import FleetMetrics, merge_prometheus_texts
from .resilience import (CircuitBreaker, Deadline, latency_quantile,
                         retry_backoff_ms)

__all__ = ["FleetRouter", "RouterApp", "NoReadyReplicaError",
           "ReplicaError"]


def _flag(name, default):
    from ...framework.flags import flag_value
    try:
        v = flag_value(name)
    except KeyError:
        return default
    return v


# data-plane traffic is always direct to the replica sockets — an
# http_proxy env var must never detour (or break) intra-fleet calls
_OPENER = urllib.request.build_opener(
    urllib.request.ProxyHandler({}))


class NoReadyReplicaError(ServerClosedError):
    """No replica is currently ready to take traffic."""


class ReplicaError(RuntimeError):
    """A replica failed mid-request (connection died after dispatch);
    only the requests riding that connection fail."""


class _Replica:
    """Router-side view of one replica. Mutable fields are guarded by
    the router lock; the breaker carries its own lock."""

    __slots__ = ("replica_id", "url", "outstanding", "ready", "alive",
                 "draining", "version", "errors", "breaker")

    def __init__(self, replica_id, url: str,
                 breaker: Optional[CircuitBreaker] = None):
        self.replica_id = replica_id
        self.url = url.rstrip("/")
        self.outstanding = 0
        self.ready = False
        self.alive = False
        self.draining = False
        self.version: Optional[str] = None
        self.errors = 0
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker()


class FleetRouter:
    """Load balancer + swap orchestrator over a replica set.

    ``replicas`` seeds a static ``{id: url}`` map; ``supervisor``
    (optional) is re-polled every health tick so spawned/respawned
    replicas join and dead ones leave automatically — when attached,
    the supervisor is authoritative for the replica set.
    ``start=False`` skips the poll thread (tests drive
    ``poll_replicas()`` explicitly)."""

    def __init__(self, replicas: Optional[Mapping] = None, *,
                 supervisor=None, retries: Optional[int] = None,
                 health_interval_ms: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 pool_size: Optional[int] = None,
                 retry_backoff_ms_: Optional[float] = None,
                 retry_backoff_max_ms: Optional[float] = None,
                 breaker_window: Optional[int] = None,
                 breaker_failure_ratio: Optional[float] = None,
                 breaker_min_samples: Optional[int] = None,
                 breaker_open_ms: Optional[float] = None,
                 breaker_latency_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 hedge_quantile: Optional[float] = None,
                 name: str = "fleet", start: bool = True):
        self.name = name
        self.supervisor = supervisor
        self.retries = int(retries if retries is not None
                           else _flag("FLAGS_fleet_retries", 2))
        self.health_interval_ms = float(
            health_interval_ms if health_interval_ms is not None
            else _flag("FLAGS_fleet_health_interval_ms", 200.0))
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else _flag("FLAGS_fleet_request_timeout_s", 120.0))
        self.retry_backoff_ms = float(
            retry_backoff_ms_ if retry_backoff_ms_ is not None
            else _flag("FLAGS_fleet_retry_backoff_ms", 10.0))
        self.retry_backoff_max_ms = float(
            retry_backoff_max_ms if retry_backoff_max_ms is not None
            else _flag("FLAGS_fleet_retry_backoff_max_ms", 500.0))
        self.hedge_ms = float(
            hedge_ms if hedge_ms is not None
            else _flag("FLAGS_fleet_hedge_ms", 0.0))
        self.hedge_quantile = float(
            hedge_quantile if hedge_quantile is not None
            else _flag("FLAGS_fleet_hedge_quantile", 0.95))
        self._breaker_kw = {
            "window": breaker_window,
            "failure_ratio": breaker_failure_ratio,
            "min_samples": breaker_min_samples,
            "open_ms": breaker_open_ms,
            "latency_threshold_ms": breaker_latency_ms,
        }
        self._rng = random.Random()     # backoff jitter
        self.metrics = FleetMetrics(name)
        # stamp this process's spans as the router's (only when nothing
        # else named the process — a worker main() names it first)
        if tracing.process_name().startswith("pid-"):
            tracing.set_process_name(f"router-{name}")
        self._lock = threading.Lock()
        self._replicas: Dict[object, _Replica] = {}
        self._rr = 0                    # round-robin tie-breaker
        self._closed = False
        self._poll_thread: Optional[threading.Thread] = None
        self._poll_wake = threading.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(pool_size) if pool_size else 32,
            thread_name_prefix=f"fleet-router-{name}")
        for rid, url in (replicas or {}).items():
            self._replicas[rid] = self._new_replica(rid, url)
        if supervisor is not None:
            self._sync_supervisor()
        self.poll_replicas()            # synchronous first probe
        if start:
            self._start_polling()

    # ------------------------------------------------------ replica set
    def _new_replica(self, replica_id, url: str) -> _Replica:
        rid = str(replica_id)
        breaker = CircuitBreaker(
            on_transition=lambda old, new:
            self.metrics.count_breaker_transition(rid, new),
            **self._breaker_kw)
        return _Replica(replica_id, url, breaker=breaker)

    def add_replica(self, replica_id, url: str):
        with self._lock:
            if replica_id not in self._replicas:
                self._replicas[replica_id] = \
                    self._new_replica(replica_id, url)

    def remove_replica(self, replica_id):
        with self._lock:
            self._replicas.pop(replica_id, None)
        self.metrics.drop_replica(str(replica_id))

    def _sync_supervisor(self):
        eps = self.supervisor.endpoints()
        with self._lock:
            for rid, url in eps.items():
                rep = self._replicas.get(rid)
                if rep is None:
                    self._replicas[rid] = self._new_replica(rid, url)
                elif rep.url != url.rstrip("/"):
                    # respawned under the same id: fresh state (the
                    # breaker resets too — a restarted replica earns
                    # its health record from scratch)
                    self._replicas[rid] = self._new_replica(rid, url)
            for rid in list(self._replicas):
                if rid not in eps:
                    self._replicas.pop(rid)

    def _http(self, url: str, data: Optional[bytes] = None,
              timeout: Optional[float] = None,
              ctype: str = "application/octet-stream"):
        req = urllib.request.Request(
            url, data=data, method="POST" if data is not None
            else "GET")
        if data is not None:
            req.add_header("Content-Type", ctype)
        return _OPENER.open(req,
                            timeout=timeout or self.request_timeout_s)

    def poll_replicas(self):
        """One readiness sweep over the known set (plus a supervisor
        re-sync when attached). The poll thread calls this on its
        cadence; tests and ``wait_ready`` call it directly."""
        if self.supervisor is not None:
            self._sync_supervisor()
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            ready, alive, version = False, False, None
            corrupt = False
            try:
                with self._http(rep.url + "/readyz",
                                timeout=max(
                                    2.0, self.health_interval_ms
                                    / 1e3)) as resp:
                    body = json.loads(resp.read() or b"{}")
                    ready, alive = bool(body.get("ready")), True
                    version = body.get("version")
                    corrupt = bool(body.get("corrupt"))
            except urllib.error.HTTPError as e:
                alive = True            # it answered: alive, not ready
                try:
                    body = json.loads(e.read() or b"{}")
                    version = body.get("version")
                    corrupt = bool(body.get("corrupt"))
                except ValueError:
                    pass
            except Exception:  # noqa: BLE001 - unreachable = not live
                pass
            with self._lock:
                if self._replicas.get(rep.replica_id) is rep:
                    rep.ready, rep.alive = ready, alive
                    if version:
                        rep.version = version
            if corrupt:
                # SDC quarantine: the replica's canary caught silent
                # corruption — not-ready alone still lets the breaker
                # half-open probe traffic back in; force it open so
                # nothing routes there until the episode clears
                rep.breaker.force_open()
        self._update_state_gauges()

    def _update_state_gauges(self):
        with self._lock:
            reps = list(self._replicas.values())
            known = len(reps)
            ready = sum(1 for r in reps
                        if r.ready and not r.draining)
            live = sum(1 for r in reps if r.alive)
            draining = sum(1 for r in reps if r.draining)
        self.metrics.set_replica_states(known, ready, live, draining)

    def _start_polling(self):
        if self._poll_thread is None or \
                not self._poll_thread.is_alive():
            self._poll_thread = threading.Thread(
                target=self._poll_loop,
                name=f"fleet-router-poll-{self.name}", daemon=True)
            self._poll_thread.start()

    def _poll_loop(self):
        while not self._closed:
            self._poll_wake.wait(self.health_interval_ms / 1e3)
            self._poll_wake.clear()
            if self._closed:
                return
            try:
                self.poll_replicas()
            except Exception:  # noqa: BLE001 - the poll loop must
                pass           # survive any replica weirdness

    def wait_ready(self, n: int = 1, timeout: float = 60.0) -> bool:
        """Block until >= n replicas are routable (ready, not
        draining)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll_replicas()
            if len(self._routable()) >= n:
                return True
            time.sleep(0.05)
        return len(self._routable()) >= n

    # ------------------------------------------------------ routing
    def _routable(self) -> List[_Replica]:
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.ready and r.alive and not r.draining]

    def _pick(self, exclude: set) -> Optional[_Replica]:
        """Least-outstanding pick over the ready set, breaker-aware:
        candidates are walked best-first and the first whose breaker
        admits a dispatch wins (``allow()`` consumes the half-open
        probe slot only for the replica actually picked — a False
        answer consumes nothing). Returns None when every candidate
        is unready or breaker-shed."""
        with self._lock:
            ready = [r for r in self._replicas.values()
                     if r.ready and r.alive and not r.draining
                     and r.replica_id not in exclude]
            if not ready:
                return None
            self._rr += 1
            rr = self._rr
            # best-first: ascending outstanding, ties rotated so equal
            # queues degrade to round-robin (the pre-breaker behavior)
            by_depth: Dict[int, List[_Replica]] = {}
            for r in ready:
                by_depth.setdefault(r.outstanding, []).append(r)
            ordered: List[_Replica] = []
            for depth in sorted(by_depth):
                tied = by_depth[depth]
                ordered.extend(tied[rr % len(tied):]
                               + tied[:rr % len(tied)])
        for rep in ordered:
            if rep.breaker.allow():
                return rep
        return None

    def _acquire(self, rep: _Replica, n: int):
        with self._lock:
            rep.outstanding += n
            out = rep.outstanding
        self.metrics.set_outstanding(str(rep.replica_id), out)

    def _release(self, rep: _Replica, n: int):
        with self._lock:
            rep.outstanding = max(0, rep.outstanding - n)
            out = rep.outstanding
        self.metrics.set_outstanding(str(rep.replica_id), out)

    def _traced_forward(self, body: bytes, n_req: int,
                        timeout_ms: Optional[float],
                        ctx) -> bytes:
        """``_forward_batch`` under a ``router::request`` root span
        (no-op wrapper when untraced). Failure records an errored root
        span, which tail-promotes an unsampled trace."""
        if ctx is None:
            return self._forward_batch(body, n_req, timeout_ms)
        rctx = ctx.child()
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        attrs = {"router": self.name, "n_req": n_req}
        try:
            payload = self._forward_batch(body, n_req, timeout_ms,
                                          ctx=rctx)
        except BaseException as e:
            tracing.record_span(
                rctx, "router::request", stage="router",
                start_unix_ns=t_wall,
                duration_ms=(time.perf_counter() - t0) * 1e3,
                status="error",
                attrs=dict(attrs,
                           error=f"{type(e).__name__}: {e}"),
                root=True)
            raise
        tracing.record_span(
            rctx, "router::request", stage="router",
            start_unix_ns=t_wall,
            duration_ms=(time.perf_counter() - t0) * 1e3,
            attrs=attrs, root=True)
        return payload

    def _forward_batch(self, body: bytes, n_req: int,
                       timeout_ms: Optional[float],
                       ctx=None) -> bytes:
        """Send one encoded batch to the best replica, with the
        resilient retry policy: breaker-aware pick, exponential
        backoff with full jitter between attempts, optional hedging
        (the batch path is idempotent), and a deadline budget that is
        deducted per hop and stamped onto the wire so the worker
        rejects expired work before dispatch. Returns the raw results
        payload (the HTTP front-end passes it through untouched; the
        Python API decodes it). With ``ctx``, every attempt gets a
        ``router::forward`` span and the batch is stamped with a
        trace trailer so the replica joins the trace."""
        self.metrics.count("routed", n_req)
        # the budget clock starts where the caller handed the work
        # over (submit_many passes a live Deadline so router-pool
        # queueing time counts against it); a raw number means this
        # hop is the ingress
        deadline = timeout_ms if isinstance(timeout_ms, Deadline) \
            else Deadline(timeout_ms)
        attempts = 0
        tried: set = set()
        while True:
            if deadline.expired():
                self.metrics.count_deadline_reject("router", n_req)
                self.metrics.count("failed", n_req)
                raise DeadlineExceededError(
                    f"deadline budget exhausted at the router after "
                    f"{attempts} attempt(s)")
            rep = self._pick(tried)
            if rep is None and tried:
                # every routable replica tried: widen to re-tries
                tried = set()
                rep = self._pick(tried)
            if rep is None:
                self.metrics.count("shed", n_req)
                raise NoReadyReplicaError(
                    "no ready replica (fleet cold, draining, "
                    "breaker-shed, or down)")
            status, value = self._dispatch_maybe_hedged(
                rep, body, n_req, deadline, ctx, attempts, tried)
            if status == "ok":
                self.metrics.count("completed", n_req)
                return value
            if status == "fatal":
                self.metrics.count("failed", n_req)
                raise value
            attempts += 1
            if attempts > self.retries:
                self.metrics.count("shed", n_req)
                raise QueueFullError(
                    f"fleet shed the batch after {attempts} "
                    f"attempts (all replicas at capacity)")
            self.metrics.count_retry(value)
            self._backoff_sleep(attempts, deadline)

    def _backoff_sleep(self, attempt: int, deadline: Deadline):
        """Jittered exponential backoff before retry ``attempt``,
        clamped to the remaining deadline budget."""
        if self.retry_backoff_ms <= 0:
            return
        ms = deadline.clamp_ms(retry_backoff_ms(
            attempt - 1, self.retry_backoff_ms,
            self.retry_backoff_max_ms, self._rng))
        if ms > 0:
            time.sleep(ms / 1e3)

    def _hedge_delay_ms(self, rep: _Replica) -> Optional[float]:
        """How long to let ``rep``'s dispatch run before hedging to a
        second replica: the ``FLAGS_fleet_hedge_quantile`` of the
        PEER replicas' rolling latency windows (the potential hedge
        targets — "someone else would usually have answered by now"),
        floored by ``FLAGS_fleet_hedge_ms``. Keying on the peers
        rather than the primary's own window matters: a uniformly
        slow primary would otherwise inflate its own trigger and
        never get hedged around. None = hedging off."""
        if self.hedge_ms <= 0:
            return None
        with self._lock:
            peers = [r for r in self._replicas.values()
                     if r is not rep and r.ready and r.alive
                     and not r.draining]
        samples: List[float] = []
        for p in peers:
            samples.extend(p.breaker.latency_window())
        q = latency_quantile(samples, self.hedge_quantile)
        return max(self.hedge_ms, q) if q is not None \
            else self.hedge_ms

    def _dispatch_maybe_hedged(self, rep: _Replica, body: bytes,
                               n_req: int, deadline: Deadline, ctx,
                               attempt: int, tried: set):
        """One retry attempt, possibly covered by a hedge: when the
        primary dispatch is still pending past the hedge delay, a
        duplicate fires to a second replica and the FIRST success
        wins (submit/submit_many are idempotent — duplicate execution
        is waste, not corruption; the loser's connection is closed
        and its eventual completion is accounted as wasted work).
        Returns ``(status, value)`` like ``_dispatch_once``; failed
        replicas are added to ``tried``."""
        delay_ms = self._hedge_delay_ms(rep)
        if delay_ms is None:
            res = self._dispatch_once(rep, body, n_req, deadline,
                                      ctx, attempt)
            if res[0] != "ok":
                tried.add(rep.replica_id)
            return res
        decided = threading.Event()
        progress = threading.Event()
        lock = threading.Lock()
        results: Dict[str, tuple] = {}
        cancels = {"primary": {"resp": None, "cancelled": False},
                   "hedge": {"resp": None, "cancelled": False}}

        def _runner(key, target_rep, hedged):
            res = self._dispatch_once(
                target_rep, body, n_req, deadline, ctx, attempt,
                hedge=hedged, cancel_box=cancels[key])
            with lock:
                results[key] = res
                late = decided.is_set()
            if late and res[0] == "ok":
                # the loser completed successfully after the winner
                # was returned (cancellation can only abort a leg
                # whose response had started arriving): duplicate
                # execution, paid for nothing
                self.metrics.count_hedge("wasted")
            progress.set()

        threading.Thread(target=_runner, args=("primary", rep, False),
                         daemon=True,
                         name=f"fleet-dispatch-{self.name}").start()
        hedge_rep: Optional[_Replica] = None
        waited_hedge_delay = False
        while True:
            wait_s = None
            if not waited_hedge_delay and hedge_rep is None:
                wait_s = deadline.clamp_ms(delay_ms) / 1e3 \
                    if deadline.bounded else delay_ms / 1e3
            fired = progress.wait(wait_s)
            progress.clear()
            if not fired and hedge_rep is None:
                # primary still pending past the hedge delay
                waited_hedge_delay = True
                hedge_rep = self._pick(tried | {rep.replica_id})
                if hedge_rep is None:
                    continue    # nobody to hedge to: wait primary out
                self.metrics.count_hedge("fired")
                threading.Thread(
                    target=_runner, args=("hedge", hedge_rep, True),
                    daemon=True,
                    name=f"fleet-hedge-{self.name}").start()
                continue
            with lock:
                p = results.get("primary")
                h = results.get("hedge")
                if p is not None and p[0] == "ok":
                    decided.set()
                elif h is not None and h[0] == "ok":
                    decided.set()
                elif p is not None and \
                        (hedge_rep is None or h is not None):
                    decided.set()   # everything launched has failed
            if not decided.is_set():
                continue
            if p is not None and p[0] == "ok":
                self._cancel_loser(cancels["hedge"])
                return p
            if h is not None and h[0] == "ok":
                self.metrics.count_hedge("won")
                self._cancel_loser(cancels["primary"])
                return h
            # both (or the only) dispatch failed: prefer the fatal
            # outcome — it must surface, not be retried away
            tried.add(rep.replica_id)
            if hedge_rep is not None and h is not None:
                tried.add(hedge_rep.replica_id)
            if p is not None and p[0] == "fatal":
                return p
            if h is not None and h[0] == "fatal":
                return h
            return p if p is not None else h

    @staticmethod
    def _cancel_loser(cancel_box: dict):
        """Abort the losing hedge leg: mark it cancelled (so its
        failure is not charged to the replica's breaker) and close
        its in-flight response to stop the transfer."""
        cancel_box["cancelled"] = True
        resp = cancel_box.get("resp")
        if resp is not None:
            try:
                resp.close()
            except OSError:
                pass

    def _dispatch_once(self, rep: _Replica, body: bytes, n_req: int,
                       deadline: Deadline, ctx, attempt: int,
                       hedge: bool = False,
                       cancel_box: Optional[dict] = None):
        """One HTTP dispatch of an encoded batch to one replica,
        classified: ``("ok", payload)``, ``("retry", reason)`` for a
        shed/unavailable outcome another replica can absorb, or
        ``("fatal", exc)`` for a mid-request death (work may have
        executed — never silently re-run outside a hedge). Records
        the outcome on the replica's breaker and, when traced, emits
        the per-attempt ``router::forward`` span."""
        remaining = deadline.remaining_ms()
        suffix = "/submit_many" if remaining is None \
            else f"/submit_many?timeout_ms={remaining}"
        # the socket timeout is bounded by the budget too (plus slack
        # for the worker's own typed rejection to travel back): a
        # hung replica must not hold an already-dead request for the
        # full FLAGS_fleet_request_timeout_s
        http_timeout = None if remaining is None else \
            min(self.request_timeout_s,
                max(0.05, remaining / 1e3 + 0.25))
        self._acquire(rep, n_req)
        fctx = ctx.child() if ctx is not None else None
        send_body = codec.attach_trace_trailer(
            body, [fctx.to_traceparent()] * n_req) \
            if fctx is not None else body
        if remaining is not None:
            send_body = codec.attach_deadline_trailer(
                send_body, [remaining] * n_req)
        span_status, span_err = "ok", None
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        try:
            try:
                resp = self._http(rep.url + suffix, data=send_body,
                                  timeout=http_timeout,
                                  ctype="application/x-paddle-fleet")
                if cancel_box is not None:
                    cancel_box["resp"] = resp
                with resp:
                    payload = resp.read()
                ms = (time.perf_counter() - t0) * 1e3
                rep.breaker.record(True, ms)
                self.metrics.observe_latency(ms)
                if ctx is not None:
                    tracing.record_exemplar(
                        "paddle_fleet_request_ms", ms, ctx.trace_id)
                return ("ok", payload)
            except urllib.error.HTTPError as e:
                e.read()
                rep.breaker.record(False)
                if e.code == 429:   # replica shed the whole batch
                    self.metrics.count_shed(str(rep.replica_id))
                    reason = "queue_full"
                elif e.code == 503:  # closed/not ready after all
                    with self._lock:
                        rep.ready = False
                    reason = "unavailable"
                else:
                    span_status, span_err = "error", f"HTTP {e.code}"
                    return ("fatal", ReplicaError(
                        f"replica {rep.replica_id} returned HTTP "
                        f"{e.code}"))
                span_status, span_err = "error", reason
                return ("retry", reason)
            except (ConnectionRefusedError, urllib.error.URLError,
                    ConnectionResetError, TimeoutError,
                    ValueError, OSError, http.client.HTTPException) as e:
                # an HTTPException (IncompleteRead) is a replica that died
                # after its response began: a mid-request death, as a
                # reset is (the reference lets it reach the caller untyped)
                if cancel_box is not None and \
                        cancel_box.get("cancelled"):
                    # the hedge race was decided against this leg and
                    # its connection was closed under it: not the
                    # replica's fault, nothing to record or report
                    span_status, span_err = "error", "hedge_cancelled"
                    return ("retry", "cancelled")
                # Refused before the request was read: nothing
                # executed, safe to re-route. Anything after dispatch
                # may have executed — fatal, don't double-run (a
                # HEDGE may still cover it: duplicate execution of
                # the idempotent batch path is explicitly allowed).
                refused = isinstance(e, ConnectionRefusedError) or \
                    isinstance(getattr(e, "reason", None),
                               ConnectionRefusedError)
                rep.breaker.record(False)
                with self._lock:
                    rep.alive = refused and rep.alive
                    rep.ready = False
                span_status = "error"
                span_err = f"{type(e).__name__}: {e}"
                if not refused:
                    return ("fatal", ReplicaError(
                        f"replica {rep.replica_id} died mid-request: "
                        f"{type(e).__name__}: {e}"))
                return ("retry", "unavailable")
        finally:
            self._release(rep, n_req)
            if fctx is not None:
                f_attrs = {"replica": str(rep.replica_id),
                           "attempt": attempt}
                if hedge:
                    f_attrs["hedge"] = True
                if span_err:
                    f_attrs["error"] = span_err
                tracing.record_span(
                    fctx, "router::forward", stage="forward",
                    start_unix_ns=t_wall,
                    duration_ms=(time.perf_counter() - t0) * 1e3,
                    status=span_status, attrs=f_attrs, root=True)

    # ------------------------------------------------------ client API
    def submit(self, feed, timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None):
        """One request -> Future of its output-array list (the
        ``InferenceServer.submit`` contract, fleet-wide)."""
        return self.submit_many([feed], timeout_ms=timeout_ms,
                                tenant=tenant)[0]

    def submit_many(self, feeds: Sequence,
                    timeout_ms: Optional[float] = None,
                    tenant: Optional[str] = None):
        """Bulk submit: the batch rides ONE replica dispatch (the
        replica's dynamic batcher coalesces it further). Returns one
        Future per request; per-request replica-side failures resolve
        individual futures, a fleet-wide shed fails them all with
        QueueFullError."""
        if self._closed:
            raise ServerClosedError("router is shut down")
        norm = []
        for f in feeds:
            if isinstance(f, dict):
                raise TypeError(
                    "fleet submit takes positional feed lists "
                    "(ordered like the model's inputs); dict feeds "
                    "are a single-process InferenceServer feature")
            norm.append([np.asarray(a) for a in f]
                        if isinstance(f, (list, tuple))
                        else [np.asarray(f)])
        body = codec.encode_batch(norm)
        if tenant is not None:
            # tenancy rides the wire as the PDTN trailer next to
            # PDTC/PDDL; the worker's admission gate reads it back
            body = codec.attach_tenant_trailer(
                body, [tenant] * len(norm))
        futs = [concurrent.futures.Future() for _ in norm]
        # trace identity is captured on the CALLER's thread (ambient
        # context or a fresh sampled one); the whole batch rides one
        # trace — the single-request submit() case is the 1:1 trace
        # the /tracez recipe documents
        ctx = tracing.request_context()
        # the deadline budget clock also starts HERE, on the caller's
        # thread — router-pool queueing time is part of the budget
        deadline = Deadline(timeout_ms)

        def _run():
            try:
                payload = self._traced_forward(body, len(norm),
                                               deadline, ctx)
                results = codec.decode_results(payload)
                if len(results) != len(futs):
                    raise ReplicaError(
                        f"replica answered {len(results)} results "
                        f"for {len(futs)} requests")
            except BaseException as e:  # noqa: BLE001 - fail them all
                for f in futs:
                    if f.set_running_or_notify_cancel():
                        f.set_exception(e)
                return
            for f, res in zip(futs, results):
                if not f.set_running_or_notify_cancel():
                    continue
                if isinstance(res, BaseException):
                    f.set_exception(res)
                else:
                    f.set_result(res)

        self._pool.submit(_run)
        return futs

    def submit_generate(self, prompt, max_new_tokens: int = 32,
                        temperature: float = 0.0,
                        timeout_ms: Optional[float] = None,
                        seed: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        tenant: Optional[str] = None
                        ) -> StreamingFuture:
        """Fleet-wide ``GenerationServer.submit_generate``: tokens
        stream back through the returned future as the chosen
        replica's decode loop emits them. ``timeout_ms`` is the
        replica-side SCHEDULING deadline (queued too long = dropped
        unrun); ``deadline_ms`` is the end-to-end HARD budget — the
        router deducts its own elapsed time before dispatch and the
        engine evicts the stream (pages freed) when the budget
        expires mid-generation. ``cancel()`` on the returned future
        propagates to the replica: the stream connection is closed so
        the engine evicts the sequence instead of decoding into a
        dead socket. Never hedged — a token stream is not
        idempotent."""
        if self._closed:
            raise ServerClosedError("router is shut down")
        fut = StreamingFuture()
        ctx = tracing.request_context()
        gctx = ctx.child() if ctx is not None else None
        req = {
            "prompt": [int(t) for t in np.asarray(prompt).ravel()],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "timeout_ms": timeout_ms, "seed": seed}
        if tenant is not None:
            req["tenant"] = str(tenant)
        if gctx is not None:
            req["traceparent"] = gctx.to_traceparent()
        deadline = Deadline(deadline_ms)
        self.metrics.count("routed")
        self._pool.submit(self._run_generate_traced, req, fut, gctx,
                          deadline)
        return fut

    def _run_generate_traced(self, req: dict, fut: StreamingFuture,
                             gctx=None,
                             deadline: Optional[Deadline] = None):
        """``_run_generate`` under a ``router::generate`` root span
        whose status mirrors the stream's outcome."""
        if gctx is None:
            return self._run_generate(req, fut, deadline)
        t_wall = time.time_ns()
        t0 = time.perf_counter()
        self._run_generate(req, fut, deadline)
        exc = fut.exception()
        reason = fut.finish_reason
        attrs = {"router": self.name,
                 "finish_reason": reason or ""}
        if exc is not None:
            attrs["error"] = f"{type(exc).__name__}: {exc}"
        tracing.record_span(
            gctx, "router::generate", stage="router",
            start_unix_ns=t_wall,
            duration_ms=(time.perf_counter() - t0) * 1e3,
            status="error" if exc is not None else "ok",
            attrs=attrs, root=True)

    def _run_generate(self, req: dict, fut: StreamingFuture,
                      deadline: Optional[Deadline] = None):
        deadline = deadline or Deadline.never()
        tried: set = set()
        for attempt in range(self.retries + 1):
            if deadline.expired():
                self.metrics.count_deadline_reject("router")
                self.metrics.count("failed")
                fut._fail(DeadlineExceededError(
                    "deadline budget exhausted at the router"),
                    reason="deadline")
                return
            rep = self._pick(tried)
            if rep is None:
                tried = set()
                rep = self._pick(tried)
            if rep is None:
                self.metrics.count("shed")
                fut._fail(NoReadyReplicaError("no ready replica"),
                          reason="shed")
                return
            # the replica sees what is LEFT of the budget, not what
            # the caller started with — elapsed router time (queueing,
            # earlier attempts, backoff) is already deducted
            body_req = dict(req)
            remaining = deadline.remaining_ms()
            if remaining is not None:
                body_req["deadline_ms"] = remaining
            body = json.dumps(body_req).encode()
            self._acquire(rep, 1)
            emitted = False
            try:
                resp = self._http(rep.url + "/generate", data=body,
                                  ctype="application/json")
                # cancel propagation: closing the stream's socket is
                # the cancel signal the replica can actually observe —
                # its next token write fails, the worker cancels the
                # engine future, the engine evicts the sequence and
                # frees its pages
                fut._set_cancel_hook(resp.close)
                try:
                    with resp:
                        for line in resp:
                            if fut._cancel_requested:
                                fut._finish("cancelled")
                                return
                            ev = json.loads(line)
                            if ev.get("done"):
                                reason = ev.get("finish_reason",
                                                "eos")
                                if ev.get("error"):
                                    # deadline evictions stay TYPED
                                    # across the wire, like the
                                    # batch codec's status codes
                                    exc = DeadlineExceededError(
                                        ev["error"]) \
                                        if reason == "deadline" \
                                        else ReplicaError(ev["error"])
                                    fut._fail(exc, reason=reason)
                                else:
                                    fut._finish(reason)
                                self.metrics.count("completed")
                                rep.breaker.record(True)
                                return
                            emitted = True
                            fut._emit(int(ev["t"]))
                finally:
                    fut._set_cancel_hook(None)
                if fut._cancel_requested:
                    # the cancel hook closed the socket under the
                    # reader: a clean cancellation, not a dead replica
                    fut._finish("cancelled")
                    return
                # stream closed without a terminal event: the replica
                # died mid-stream
                raise ReplicaError(
                    f"replica {rep.replica_id} closed the stream "
                    f"mid-generation")
            except urllib.error.HTTPError as e:
                e.read()
                rep.breaker.record(False)
                if e.code in (429, 503) and not emitted:
                    self.metrics.count_retry(
                        "queue_full" if e.code == 429
                        else "unavailable")
                    if e.code == 429:
                        self.metrics.count_shed(str(rep.replica_id))
                    tried.add(rep.replica_id)
                    self._backoff_sleep(attempt + 1, deadline)
                    continue
                self.metrics.count("failed")
                fut._fail(QueueFullError(f"HTTP {e.code}")
                          if e.code == 429
                          else ReplicaError(f"HTTP {e.code}"),
                          reason="error")
                return
            except BaseException as e:  # noqa: BLE001 - tokens may
                # already be consumed: never silently re-run the
                # stream on another replica
                if fut._cancel_requested:
                    # socket torn down by the cancel hook mid-read
                    fut._finish("cancelled")
                    return
                rep.breaker.record(False)
                if not emitted and isinstance(
                        e, (ConnectionRefusedError,
                            urllib.error.URLError)):
                    with self._lock:
                        rep.ready = False
                    self.metrics.count_retry("unavailable")
                    tried.add(rep.replica_id)
                    self._backoff_sleep(attempt + 1, deadline)
                    continue
                self.metrics.count("failed")
                fut._fail(ReplicaError(
                    f"replica {rep.replica_id} stream failed: "
                    f"{type(e).__name__}: {e}"), reason="error")
                return
            finally:
                self._release(rep, 1)
        self.metrics.count("shed")
        fut._fail(QueueFullError(
            f"fleet shed the stream after {self.retries + 1} "
            f"attempts"), reason="shed")

    # ------------------------------------------------------ hot swap
    def swap_weights(self, model_prefix: str, *,
                     drain_timeout_s: Optional[float] = None,
                     ready_timeout_s: float = 300.0) -> dict:
        """Rolling hot weight swap: drain -> /reload -> ready, one
        replica at a time. Raises on the first failed replica (the
        already-swapped ones keep the new weights, the rest keep the
        old — the fleet stays serviceable either way); the drained
        replica is always returned to rotation."""
        drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else _flag("FLAGS_fleet_drain_timeout_s", 30.0))
        report = {"model_prefix": str(model_prefix), "replicas": []}
        with self._lock:
            order = sorted(self._replicas,
                           key=lambda rid: str(rid))
        for rid in order:
            with self._lock:
                rep = self._replicas.get(rid)
                if rep is None or not rep.alive:
                    continue
                rep.draining = True
            self._update_state_gauges()
            t0 = time.perf_counter()
            try:
                self._drain_one(rep, drain_timeout_s)
                t_drained = time.perf_counter()
                with self._http(
                        rep.url + "/reload",
                        data=json.dumps(
                            {"model_prefix": str(model_prefix)}
                        ).encode(),
                        ctype="application/json",
                        timeout=ready_timeout_s) as resp:
                    version = json.loads(resp.read()).get("version")
                self._await_ready(rep, ready_timeout_s)
                self.metrics.count_swap("replica_reloaded")
                report["replicas"].append({
                    "replica": str(rid), "version": version,
                    "drain_ms": round((t_drained - t0) * 1e3, 1),
                    "reload_ms": round(
                        (time.perf_counter() - t_drained) * 1e3, 1)})
            except BaseException:
                self.metrics.count_swap("failed")
                raise
            finally:
                with self._lock:
                    rep.draining = False
                self._update_state_gauges()
        self.metrics.count_swap("completed")
        return report

    def _drain_one(self, rep: _Replica, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if rep.outstanding == 0:
                    return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {rep.replica_id} still has "
                    f"{rep.outstanding} outstanding after "
                    f"{timeout_s}s drain")
            time.sleep(0.002)

    def _await_ready(self, rep: _Replica, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                with self._http(rep.url + "/readyz",
                                timeout=5.0) as resp:
                    if json.loads(resp.read()).get("ready"):
                        with self._lock:
                            rep.ready, rep.alive = True, True
                        return
            except Exception:  # noqa: BLE001 - keep polling until the
                pass           # deadline decides
            time.sleep(0.02)
        raise TimeoutError(
            f"replica {rep.replica_id} not ready again within "
            f"{timeout_s}s of reload")

    # ------------------------------------------------------ inspection
    def replica_states(self) -> List[dict]:
        with self._lock:
            reps = list(self._replicas.values())
        return [{"replica": str(r.replica_id), "url": r.url,
                 "ready": r.ready, "alive": r.alive,
                 "draining": r.draining,
                 "outstanding": r.outstanding,
                 "version": r.version,
                 "breaker": r.breaker.snapshot()}
                for r in reps]

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def merged_metrics(self) -> str:
        """Fleet-wide Prometheus scrape: this process's registry plus
        every live replica's /metrics re-labeled with its id."""
        from ...observability import default_registry, prometheus_text
        texts = {}
        with self._lock:
            reps = [(str(r.replica_id), r.url)
                    for r in self._replicas.values() if r.alive]
        for rid, url in reps:
            try:
                with self._http(url + "/metrics",
                                timeout=5.0) as resp:
                    texts[rid] = resp.read().decode()
            except Exception:  # noqa: BLE001 - a scrape-dead replica
                pass           # just drops out of the merged view
        return merge_prometheus_texts(
            texts, own=prometheus_text(default_registry()))

    def merged_tracez(self, trace_id: Optional[str] = None,
                      min_duration_ms: Optional[float] = None,
                      limit: int = 100) -> dict:
        """Fleet-wide ``/tracez``: this process's flight recorder plus
        every live replica's, stitched by trace id — the router span,
        the worker span, and the engine's queue/assembly/dispatch/
        device/fetch children come back as ONE trace."""
        remote: List[dict] = []
        with self._lock:
            reps = [(str(r.replica_id), r.url)
                    for r in self._replicas.values() if r.alive]
        q = f"?limit={int(limit)}"
        if trace_id:
            q += f"&trace_id={trace_id}"
        for rid, url in reps:
            try:
                with self._http(url + "/tracez" + q,
                                timeout=5.0) as resp:
                    doc = json.loads(resp.read())
                for t in doc.get("traces", []):
                    remote.extend(t.get("spans", []))
            except Exception:  # noqa: BLE001 - a scrape-dead replica
                pass           # drops out of the merged view
        return tracing.tracez_payload(
            trace_id=trace_id, min_duration_ms=min_duration_ms,
            limit=limit, extra_spans=remote)

    def merged_sloz(self) -> dict:
        """Fleet-wide ``/sloz``: this process's SLO evaluation plus
        every live replica's, with rolling-window good/total counts
        summed per (SLO, window) — fleet attainment, the way
        ``merged_tracez`` stitches spans."""
        from ...observability import slo as slo_mod
        own = slo_mod.sloz_payload()
        remotes: Dict[str, dict] = {}
        with self._lock:
            reps = [(str(r.replica_id), r.url)
                    for r in self._replicas.values() if r.alive]
        for rid, url in reps:
            try:
                with self._http(url + "/sloz", timeout=5.0) as resp:
                    remotes[rid] = json.loads(resp.read())
            except Exception:  # noqa: BLE001 - a scrape-dead replica
                pass           # drops out of the merged view
        return slo_mod.merge_sloz_payloads(own, remotes)

    def merged_schedz(self) -> dict:
        """Fleet-wide ``/schedz``: this process's admission/autoscaler
        state plus every live replica's, with per-tenant admission
        event counts summed fleet-wide — one scrape answers "who is
        being shed, where, and what did the autoscaler last do"."""
        from ..scheduling import schedz as schedz_mod
        own = schedz_mod.schedz_payload()
        remotes: Dict[str, dict] = {}
        with self._lock:
            reps = [(str(r.replica_id), r.url)
                    for r in self._replicas.values() if r.alive]
        for rid, url in reps:
            try:
                with self._http(url + "/schedz", timeout=5.0) as resp:
                    remotes[rid] = json.loads(resp.read())
            except Exception:  # noqa: BLE001 - a scrape-dead replica
                pass           # drops out of the merged view
        return schedz_mod.merge_schedz_payloads(own, remotes)

    def statusz(self) -> dict:
        """Fleet status page: per-replica id/readiness/outstanding/
        version (+ restart counts when a supervisor is attached) and
        the router's own counters — the single-server ``/statusz``
        parity view for a fleet."""
        replicas = self.replica_states()
        restarts = {}
        if self.supervisor is not None:
            try:
                restarts = {str(k): v for k, v in
                            self.supervisor.restart_counts().items()}
            except Exception:  # noqa: BLE001 - status must not 500 on
                pass           # a half-stopped supervisor
        for r in replicas:
            r["restarts"] = restarts.get(r["replica"], 0)
        return {
            "router": self.name,
            "pid": os.getpid(),
            "replicas": replicas,
            "ready_replicas": sum(1 for r in replicas
                                  if r["ready"] and not r["draining"]),
            "restarts_total": sum(restarts.values()),
            "metrics": self.metrics_snapshot(),
        }

    # ------------------------------------------------------ lifecycle
    def shutdown(self):
        self._closed = True
        self._poll_wake.set()
        t = self._poll_thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


# ---------------------------------------------------------------- http
class _RouterHandler(BaseHTTPRequestHandler):
    """HTTP front-end over a FleetRouter: the external data plane.

    ``POST /submit_many`` and ``POST /generate`` speak the replica
    wire protocol (codec.py / ndjson) and PASS THE BODY THROUGH — the
    router never decodes the arrays, so its per-request CPU cost is a
    replica pick plus a socket copy. Serving-layer errors map to the
    same status codes replicas use (429 shed, 503 no ready replica),
    so a client cannot tell one server from a fleet."""

    server_version = "paddle-tpu-fleet-router/1.0"

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @property
    def _router(self) -> FleetRouter:
        return self.server.router  # type: ignore[attr-defined]

    def log_message(self, *args):
        pass

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler ABI
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                from ...observability import (default_registry,
                                              prometheus_text)
                from ...observability.exposition import \
                    PROMETHEUS_CONTENT_TYPE
                text = self._router.merged_metrics() \
                    if "merged=1" in query \
                    else prometheus_text(default_registry())
                self._send(200, text.encode(),
                           PROMETHEUS_CONTENT_TYPE)
            elif path == "/healthz":
                live = any(s["alive"]
                           for s in self._router.replica_states())
                self._send(200 if live else 503, json.dumps(
                    {"ok": live,
                     "replicas": self._router.replica_states()},
                    sort_keys=True).encode())
            elif path == "/readyz":
                n = len(self._router._routable())
                self._send(200 if n else 503, json.dumps(
                    {"ready": bool(n),
                     "ready_replicas": n}).encode())
            elif path == "/statusz":
                self._send(200, json.dumps(
                    self._router.statusz(),
                    sort_keys=True, default=str).encode())
            elif path == "/tracez":
                from urllib.parse import parse_qs
                q = {k: v[-1] for k, v in parse_qs(query).items()}
                doc = self._router.merged_tracez(
                    trace_id=q.get("trace_id") or None,
                    min_duration_ms=float(q["min_ms"])
                    if q.get("min_ms") else None,
                    limit=int(q.get("limit", 100)))
                if q.get("format") == "chrome":
                    from ...observability import tracing as _tracing
                    spans = [s for t in doc["traces"]
                             for s in t["spans"]]
                    doc = {"traceEvents":
                           _tracing.chrome_trace_events(spans)}
                self._send(200, json.dumps(doc, sort_keys=True,
                                           default=str).encode())
            elif path == "/sloz":
                self._send(200, json.dumps(
                    self._router.merged_sloz(), sort_keys=True,
                    default=str).encode())
            elif path == "/schedz":
                self._send(200, json.dumps(
                    self._router.merged_schedz(), sort_keys=True,
                    default=str).encode())
            elif path in UNPORTED_ENDPOINTS:
                self._send(501, json.dumps(
                    {"error": "not implemented", "endpoint": path,
                     "detail": UNPORTED_ENDPOINTS[path]},
                    sort_keys=True).encode())
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as e:  # noqa: BLE001 - handler fault barrier
            try:
                self._send(500, f"{e!r}\n".encode(), "text/plain")
            except Exception:  # noqa: BLE001
                pass

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler ABI
        path, _, query = self.path.partition("?")
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            if path == "/submit_many":
                timeout_ms = None
                for part in query.split("&"):
                    if part.startswith("timeout_ms="):
                        timeout_ms = \
                            float(part.split("=", 1)[1]) or None
                # external ingress deadline: the x-paddle-deadline-ms
                # header is the caller's REMAINING budget (the header
                # twin of the codec deadline trailer); it wins over
                # the scheduling timeout as the propagated budget
                hdr = self.headers.get("x-paddle-deadline-ms")
                if hdr:
                    try:
                        timeout_ms = float(hdr) or None
                    except ValueError:
                        pass
                n_req = codec.peek_batch_size(body)
                # tenant ingress: the x-paddle-tenant header is the
                # header twin of the PDTN trailer. attach is
                # idempotent — a trailer already stamped upstream wins
                t_hdr = self.headers.get("x-paddle-tenant")
                if t_hdr:
                    body = codec.attach_tenant_trailer(
                        body, [t_hdr] * n_req)
                # external ingress: honor the caller's traceparent
                # header, else make the head-sampling decision here
                ctx = tracing.parse_traceparent(
                    self.headers.get("traceparent")) or \
                    tracing.request_context()
                payload = self._router._traced_forward(
                    body, n_req, timeout_ms, ctx)
                self._send(200, payload, "application/x-paddle-fleet")
            elif path == "/generate":
                self._generate(body)
            else:
                self._send(404, b"not found\n", "text/plain")
        except DeadlineExceededError as e:
            self._send(504, f"{e}\n".encode(), "text/plain")
        except NoReadyReplicaError as e:
            self._send(503, f"{e}\n".encode(), "text/plain")
        except QueueFullError as e:
            self._send(429, f"{e}\n".encode(), "text/plain")
        except codec.CodecError as e:
            self._send(400, f"{e}\n".encode(), "text/plain")
        except Exception as e:  # noqa: BLE001 - handler fault barrier
            try:
                self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                           "text/plain")
            except Exception:  # noqa: BLE001
                pass

    def _generate(self, body: bytes):
        req = json.loads(body or b"{}")
        ctx = tracing.parse_traceparent(
            req.get("traceparent")
            or self.headers.get("traceparent"))
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is None:
            hdr = self.headers.get("x-paddle-deadline-ms")
            if hdr:
                try:
                    deadline_ms = float(hdr) or None
                except ValueError:
                    pass
        # tenant: the JSON field wins over the x-paddle-tenant header
        tenant = req.get("tenant") or \
            self.headers.get("x-paddle-tenant")
        with tracing.use_context(ctx):
            fut = self._router.submit_generate(
                req["prompt"],
                max_new_tokens=int(req.get("max_new_tokens", 32)),
                temperature=float(req.get("temperature", 0.0)),
                timeout_ms=req.get("timeout_ms"),
                seed=req.get("seed"),
                deadline_ms=deadline_ms,
                tenant=tenant)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            for tok in fut:
                self.wfile.write(
                    json.dumps({"t": int(tok)}).encode() + b"\n")
                self.wfile.flush()
            self.wfile.write(json.dumps(
                {"done": True,
                 "finish_reason": fut.finish_reason}).encode() + b"\n")
        except BrokenPipeError:
            fut.cancel()
        except BaseException as e:  # noqa: BLE001 - stream the error
            reason = "deadline" \
                if isinstance(e, DeadlineExceededError) else "error"
            try:
                self.wfile.write(json.dumps(
                    {"done": True, "finish_reason": reason,
                     "error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n")
            except OSError:
                pass


class _RouterServer(ThreadingHTTPServer):
    # clients open many connections at once: a listen backlog of 5 (the
    # standard library's) overflows under load and the kernel drops or
    # resets them
    request_queue_size = 128


class RouterApp:
    """The router's HTTP front-end on a daemon thread (same shape as
    worker.ReplicaApp). ``port=0`` binds ephemeral."""

    def __init__(self, router: FleetRouter, host: str = "0.0.0.0",
                 port: int = 0):
        self.router = router
        self.host = host
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def url(self, path: str = "") -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "::") \
            else self.host
        return f"http://{host}:{self.port}{path}"

    def start(self) -> "RouterApp":
        if self._httpd is not None:
            return self
        httpd = _RouterServer((self.host, self._requested_port),
                              _RouterHandler)
        httpd.daemon_threads = True
        httpd.router = self.router      # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name=f"fleet-router-http-{self.router.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
