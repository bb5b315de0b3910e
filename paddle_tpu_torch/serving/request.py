"""Typed serving errors (the port of ``paddle_tpu/serving/request.py:22-47``)."""
from __future__ import annotations

__all__ = ["QueueFullError", "DeadlineExceededError", "ServerClosedError"]


class QueueFullError(RuntimeError):
    """Raised by ``submit_generate`` when the bounded request queue is at
    capacity — the backpressure signal; callers shed load or retry with
    their own policy instead of growing an unbounded queue."""


class DeadlineExceededError(TimeoutError):
    """Set on a request's future when its deadline passed: before it could
    be scheduled (scheduling deadline), or while it was still streaming
    (hard deadline)."""


class ServerClosedError(RuntimeError):
    """Raised by ``submit_generate`` after shutdown began, and set on
    still-queued futures when shutdown is not draining."""
