"""Request/Future plumbing and the typed serving errors (the port of
``paddle_tpu/serving/request.py``).

A request is a list of numpy feed arrays (ordered by the predictor's feed
names) plus a ``concurrent.futures.Future`` the caller blocks on; the
dynamic batcher (``batcher.py``) owns the queue of them and the server's
threads resolve the futures. The generation engine raises the same errors.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["QueueFullError", "QuotaExceededError", "DeadlineExceededError",
           "ServerClosedError", "Request"]


class QueueFullError(RuntimeError):
    """Raised by ``submit``/``submit_generate`` when the bounded request
    queue is at capacity — the backpressure signal; callers shed load or
    retry with their own policy instead of growing an unbounded queue."""


class QuotaExceededError(QueueFullError):
    """Per-tenant shed (a tenant's quota rejected the request). Subclasses
    ``QueueFullError`` so untyped shed paths treat it as load shedding;
    ``.tenant`` names the tenant. The scheduler's ``admit`` raises it, and
    the generation engine sets it on a parked stream that cannot resume."""

    def __init__(self, message: str = "tenant quota exceeded",
                 tenant: str = "default"):
        super().__init__(message)
        self.tenant = tenant


class DeadlineExceededError(TimeoutError):
    """Set on a request's future when its deadline passed: before it could
    be scheduled (the request is dropped, never run), or, for a generation
    request, while it was still streaming (hard deadline)."""


class ServerClosedError(RuntimeError):
    """Raised by ``submit`` after shutdown began, and set on still-queued
    futures when shutdown is not draining."""


class Request:
    """One inference request: per-feed arrays and the future resolved with
    the per-request output list (outputs unpadded back to the request's own
    rows and sequence length).

    ``trace`` (a ``tracing.TraceContext`` or None) marks the request as
    traced: the server emits queue/assembly/dispatch/device_wait/fetch spans
    into its trace. Warmup requests never carry one."""

    __slots__ = ("feeds", "rows", "future", "submit_t", "deadline",
                 "signature", "orig_seq", "trace", "t_wall_ns", "tenant")

    def __init__(self, feeds: List[np.ndarray], rows: int,
                 signature: Tuple, orig_seq: Optional[List[int]] = None,
                 timeout_ms: Optional[float] = None, trace=None,
                 tenant: Optional[str] = None):
        self.feeds = feeds
        self.rows = rows
        self.signature = signature
        self.orig_seq = orig_seq
        self.tenant = tenant
        self.future: Future = Future()
        self.submit_t = time.monotonic()
        self.deadline = (self.submit_t + timeout_ms / 1e3
                         if timeout_ms else None)
        self.trace = trace
        self.t_wall_ns = time.time_ns() if trace is not None else 0

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline

    def latency_ms(self) -> float:
        return (time.monotonic() - self.submit_t) * 1e3
