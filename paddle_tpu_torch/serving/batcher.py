"""Dynamic batcher: bounded queue and compatible-request coalescing (the
port of ``paddle_tpu/serving/batcher.py``).

Requests queue up; the server's worker drains the queue and coalesces
shape-compatible requests (same ``ShapeBucketPolicy`` signature) into one
device batch, dispatching when ``max_batch_size`` rows are gathered or
``max_wait_ms`` elapsed since the oldest gathered request, whichever comes
first. Incompatible requests stay queued in order for a later cycle; a full
batch of another signature dispatches without waiting out the oldest
request's window.

The queue is bounded: ``put`` raises ``QueueFullError`` at capacity
(backpressure), and expired or cancelled requests are resolved and skipped
at drain time, never run. Per-signature row counts are kept incrementally,
so the batch-ready check walks the live signatures, not the queue, and the
expiry sweep is skipped while no queued request carries a deadline.

With a ``scheduler`` (a ``scheduling.AdmissionController``) ``put`` debits
the request's tenant by its rows and raises the typed
``QuotaExceededError`` when the tenant's bucket is empty, and a window that
closes without a full batch goes to the tenant with the lowest virtual
finish tag (priority classes first) instead of the oldest request.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .request import DeadlineExceededError, QueueFullError, Request

__all__ = ["DynamicBatcher"]


class DynamicBatcher:
    def __init__(self, max_batch_size: int = 8, max_wait_ms: float = 2.0,
                 capacity: int = 64, metrics=None, scheduler=None):
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.capacity = int(capacity)
        self.metrics = metrics
        # optional scheduling.AdmissionController: per-tenant quota on
        # put() (typed QuotaExceededError sheds) and the weighted-fair
        # head pick in next_batch() when no bucket is full
        self.scheduler = scheduler
        self._q: deque = deque()
        self._sig_rows: Dict[Tuple, int] = {}  # queued rows per signature
        self._deadlined = 0                    # queued reqs with deadlines
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._stopping = False

    def __len__(self):
        with self._lock:
            return len(self._q)

    def _note_depth(self):
        if self.metrics is not None:
            self.metrics.queue_depth(len(self._q), self.capacity)

    # ---- signature bookkeeping (lock held) ----
    def _track(self, req: Request):
        self._sig_rows[req.signature] = \
            self._sig_rows.get(req.signature, 0) + req.rows
        if req.deadline is not None:
            self._deadlined += 1

    def _untrack(self, req: Request):
        n = self._sig_rows.get(req.signature, 0) - req.rows
        if n > 0:
            self._sig_rows[req.signature] = n
        else:
            self._sig_rows.pop(req.signature, None)
        if req.deadline is not None:
            self._deadlined -= 1

    # ---- producer side ----
    def put(self, req: Request):
        if self.scheduler is not None:
            # per-tenant quota gate (cost = request rows); raises the
            # typed QuotaExceededError, a QueueFullError subclass, so
            # untyped callers shed it as backpressure. The controller has
            # its own lock: gate before taking ours.
            self.scheduler.admit(getattr(req, "tenant", None),
                                 cost=float(req.rows))
        with self._lock:
            if len(self._q) >= self.capacity:
                raise QueueFullError(
                    f"serving queue at capacity ({self.capacity}); "
                    f"shed load or raise FLAGS_serving_queue_capacity")
            self._q.append(req)
            self._track(req)
            self._note_depth()
            self._not_empty.notify()

    def put_many(self, reqs: List[Request]):
        """Bulk enqueue: ONE lock acquisition + notify for the whole
        list (a per-request ``put`` loop pays lock/notify/depth-metric
        per request). All-or-nothing: raises QueueFullError without
        enqueueing anything if the batch doesn't fit. Not quota-gated, as
        the reference's: the bulk path belongs to a fleet worker, which
        sheds per tenant at its own admission point."""
        with self._lock:
            if len(self._q) + len(reqs) > self.capacity:
                raise QueueFullError(
                    f"serving queue cannot take {len(reqs)} more "
                    f"requests (depth {len(self._q)}, capacity "
                    f"{self.capacity}); shed load or raise "
                    f"FLAGS_serving_queue_capacity")
            self._q.extend(reqs)
            for r in reqs:
                self._track(r)
            self._note_depth()
            self._not_empty.notify_all()

    def stop(self):
        with self._lock:
            self._stopping = True
            self._not_empty.notify_all()

    def cancel_pending(self, exc: Exception):
        """Resolve every queued request with ``exc`` (non-drain
        shutdown)."""
        with self._lock:
            pending = list(self._q)
            self._q.clear()
            self._sig_rows.clear()
            self._deadlined = 0
            self._note_depth()
        for r in pending:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(exc)
            if self.metrics is not None:
                self.metrics.count("cancelled")

    # ---- consumer side ----
    def _reap(self, now: float) -> None:
        """Drop expired / caller-cancelled requests in place (lock
        held). Expired ones get DeadlineExceededError — they are never
        run; the deadline covers queueing, the stage that actually grows
        under load. Skipped while nothing queued carries a deadline
        (cancelled no-deadline requests are caught at resolve time by
        ``set_running_or_notify_cancel``)."""
        if not self._deadlined:
            return
        keep = deque()
        for r in self._q:
            if r.future.cancelled():
                self._untrack(r)
                if self.metrics is not None:
                    self.metrics.count("cancelled")
                continue
            if r.expired(now):
                self._untrack(r)
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(DeadlineExceededError(
                        f"request waited {r.latency_ms():.1f}ms in queue, "
                        f"past its deadline"))
                if self.metrics is not None:
                    self.metrics.count("timed_out")
                if getattr(r, "trace", None) is not None:
                    # deadline expiry is a tail event: record the
                    # queue-wait as an errored span
                    from ..observability import tracing
                    tracing.record_span(
                        r.trace, "serving::queue", stage="queue",
                        start_unix_ns=r.t_wall_ns,
                        duration_ms=r.latency_ms(), status="error",
                        attrs={"error": "DeadlineExceededError"},
                        root=True)
                continue
            keep.append(r)
        if len(keep) != len(self._q):
            self._q = keep
            self._note_depth()

    def _full_signature(self):
        """A signature whose queued rows already fill a batch — the
        head-of-line request's if it qualifies, else the earliest-seen
        full one — or None (lock held)."""
        if self._q and \
                self._sig_rows.get(self._q[0].signature, 0) >= \
                self.max_batch_size:
            return self._q[0].signature
        for sig, rows in self._sig_rows.items():
            if rows >= self.max_batch_size:
                return sig
        return None

    def next_batch(self) -> Optional[List[Request]]:
        """Block until a batch is ready; None once stopping and empty.

        The batch is the head-of-line request plus every queued request
        sharing its signature, in arrival order, up to
        ``max_batch_size`` total rows; the window closes early when the
        row budget is filled — by the head's signature or by ANY other
        queued signature (a full batch of a different shape bucket must
        not head-of-line-block behind the oldest request's window; with
        the pipelined executor both buckets can be in flight at once)."""
        with self._lock:
            while True:
                self._reap(time.monotonic())
                if not self._q:
                    if self._stopping:
                        return None
                    self._not_empty.wait(0.05)
                    continue

                head = self._q[0]
                target = head.signature
                # the coalescing window is anchored on the OLDEST queued
                # request: one that already waited its share dispatches
                # immediately instead of paying the window again
                window_end = head.submit_t + self.max_wait_ms / 1e3
                while not self._stopping:
                    full = self._full_signature()
                    if full is not None:
                        target = full
                        break
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._not_empty.wait(remaining)
                    self._reap(time.monotonic())
                    if not self._q:
                        break
                    head = self._q[0]
                    target = head.signature
                if not self._q:
                    continue  # everything expired/cancelled mid-wait

                if (self.scheduler is not None and len(self._q) > 1
                        and self._full_signature() is None):
                    # the window closed without a full bucket: the
                    # dispatch slot goes to the tenant with the lowest
                    # virtual finish tag (weighted-fair across tenants,
                    # priority classes first) instead of strict FIFO
                    sel = self.scheduler.select(self._q)
                    if sel is not None:
                        target = self._q[sel].signature

                batch, rest, rows = [], deque(), 0
                for r in self._q:
                    if r.signature == target and (
                            not batch
                            or rows + r.rows <= self.max_batch_size):
                        batch.append(r)
                        rows += r.rows
                    else:
                        rest.append(r)
                self._q = rest
                for r in batch:
                    self._untrack(r)
                self._note_depth()
                return batch
