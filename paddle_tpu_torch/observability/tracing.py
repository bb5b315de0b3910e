"""Request tracing: the part of ``paddle_tpu/observability/tracing.py`` that
the dynamic-batching server calls (``request_context``, ``record_span``)
and the context type they pass around.

- ``TraceContext``: a request's identity (128-bit trace id, 64-bit span id,
  sampled flag) in the W3C ``traceparent`` shape.
- ``use_context``: a thread's ambient context; ``request_context`` picks it
  up at ``submit``.
- ``record_span``: one typed, timed unit of work (``stage``: queue,
  assembly, dispatch, device_wait, fetch, request, shed) under a context,
  kept in a bounded in-process list that ``spans()`` reads.

The reference's flight recorder (per-trace caps, tail promotion of
unsampled requests), exemplars, head sampling with the ``FLAGS_trace_*``
knobs, the ``/tracez`` payload and chrome export wait for the operations
plane (ROADMAP queue 1 item 5b). Until then a request is traced only under
a context its caller sets. Pure standard library.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import List, Optional

__all__ = ["TraceContext", "new_context", "request_context",
           "current_context", "use_context", "record_span", "spans"]

MAX_SPANS = 4096    # the reference's FLAGS_trace_buffer_spans default


def _gen_span_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """Identity of one request's trace at one point in the call tree:
    ``span_id`` is the current span (child spans parent to it),
    ``parent_id`` its own parent."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, parent_id: str = "",
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = bool(sampled)

    def child(self) -> "TraceContext":
        """A fresh span identity under this one, in the same trace."""
        return TraceContext(self.trace_id, _gen_span_id(),
                            parent_id=self.span_id, sampled=self.sampled)


def new_context(sampled: bool = True) -> TraceContext:
    """Mint a fresh trace."""
    return TraceContext(os.urandom(16).hex(), _gen_span_id(),
                        sampled=sampled)


_tls = threading.local()


def current_context() -> Optional[TraceContext]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Make ``ctx`` this thread's ambient context (``submit`` picks it
    up)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def request_context() -> Optional[TraceContext]:
    """The context a request is traced under: the ambient one, else None
    (the reference's behaviour at its default sample rate of 0)."""
    return current_context()


_lock = threading.Lock()
_spans: deque = deque(maxlen=MAX_SPANS)


def record_span(ctx: Optional[TraceContext], name: str, *, stage: str = "",
                start_unix_ns: int, duration_ms: float,
                attrs: Optional[dict] = None, status: str = "ok",
                root: bool = False) -> Optional[dict]:
    """Record one measured span under ``ctx`` (nothing when untraced or
    unsampled). ``root=True`` records it as the context's own span id;
    otherwise a fresh child id is minted."""
    if ctx is None or not ctx.sampled:
        return None
    span = {"trace_id": ctx.trace_id,
            "span_id": ctx.span_id if root else _gen_span_id(),
            "parent_id": ctx.parent_id if root else ctx.span_id,
            "name": name, "stage": stage, "pid": os.getpid(),
            "tid": threading.get_ident(),
            "start_unix_ns": int(start_unix_ns),
            "duration_ms": float(duration_ms), "status": status,
            "attrs": dict(attrs) if attrs else {}}
    with _lock:
        _spans.append(span)
    return span


def spans(trace_id: Optional[str] = None) -> List[dict]:
    """The recorded spans, oldest first (or one trace's)."""
    with _lock:
        out = list(_spans)
    return [s for s in out if trace_id is None or s["trace_id"] == trace_id]
