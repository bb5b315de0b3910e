"""Request tracing: spans from ingress to the device step (the port of
``paddle_tpu/observability/tracing.py``).

- **TraceContext**: a request's identity (128-bit trace id, 64-bit span
  id, sampled flag) in the W3C ``traceparent`` shape
  (``00-<32hex>-<16hex>-<02x>``); ``request_context()`` mints one at
  ingress.
- **Span**: one typed, timed unit of work (``stage`` names the pipeline
  stage: queue / assembly / dispatch / device_wait / fetch / prefill /
  decode_step / verify / shed / request), with a wall-clock start, a
  measured duration, attrs and an ok/error status.
- **SpanBuffer**: the flight recorder, a lock-guarded bounded ring of
  completed spans (``FLAGS_trace_buffer_spans``) with a per-trace cap
  (``FLAGS_trace_max_spans_per_trace``), so one long decode stream cannot
  evict everything else. ``/tracez`` on the telemetry endpoint serves it.
- **Head sampling and tail promotion**: ``FLAGS_trace_sample_rate``
  decides at ingress, deterministically from the trace id; spans of an
  unsampled request are parked on its context and flushed only if the
  request later errors, sheds or blows a deadline (``promote``).
- **Exemplars**: ``record_exemplar`` keeps the latest trace id seen per
  latency-histogram bucket, so a bad bucket of
  ``paddle_serving_latency_ms`` links to a retrievable trace.
- **Chrome export**: ``export_chrome_trace`` writes spans in the
  ``{"traceEvents": [...]}`` schema.

``spans(trace_id)`` reads the default recorder as a list of span dicts.
Standard library only.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "TraceContext", "Span", "SpanBuffer",
    "new_context", "request_context", "current_context", "use_context",
    "parse_traceparent", "sample_decision",
    "start_span", "record_span", "promote",
    "default_buffer", "set_default_buffer",
    "group_traces", "tracez_payload", "merge_span_dicts",
    "chrome_trace_events", "export_chrome_trace",
    "record_exemplar", "exemplars", "clear_exemplars",
    "set_process_name", "process_name", "spans",
]


def _flag(name, default):
    from ..framework.flags import flag_value
    try:
        return flag_value(name)
    except KeyError:
        return default


_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def _gen_trace_id() -> str:
    return os.urandom(16).hex()


def _gen_span_id() -> str:
    return os.urandom(8).hex()


def sample_decision(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling decision: a hash-free projection of
    the trace id onto [0, 1) compared against ``rate``. Every process
    that sees the same trace id makes the same call, so a trace is
    never half-sampled across the fleet."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:16], 16) / float(1 << 64) < rate


class _TraceState:
    """Per-trace, per-process mutable state shared by every context of
    one trace: the parked spans of an unsampled request (flushed on
    promotion) and the promotion flag itself."""

    __slots__ = ("lock", "pending", "promoted", "dropped")

    def __init__(self):
        self.lock = threading.Lock()
        self.pending: List["Span"] = []
        self.promoted = False
        self.dropped = 0


class TraceContext:
    """Identity of one request's trace at one point in the call tree:
    ``span_id`` is the CURRENT span (new child spans parent to it),
    ``parent_id`` is its own parent (used when the span for this
    context is recorded)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled",
                 "state")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str = "", sampled: bool = False,
                 state: Optional[_TraceState] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = bool(sampled)
        self.state = state if state is not None else _TraceState()

    def child(self) -> "TraceContext":
        """A fresh span identity under this one (same trace, same
        local state)."""
        return TraceContext(self.trace_id, _gen_span_id(),
                            parent_id=self.span_id,
                            sampled=self.sampled, state=self.state)

    @property
    def recording(self) -> bool:
        return self.sampled or self.state.promoted

    def to_traceparent(self) -> str:
        flags = 1 if self.recording else 0
        return f"00-{self.trace_id}-{self.span_id}-{flags:02x}"

    def __repr__(self):
        return (f"TraceContext({self.to_traceparent()!r}, "
                f"promoted={self.state.promoted})")


def parse_traceparent(header: Optional[str]
                      ) -> Optional[TraceContext]:
    """W3C-shaped ``traceparent`` -> context, or None for anything
    malformed (a bad header degrades to 'untraced', never an error)."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id,
                        sampled=bool(int(flags, 16) & 1))


def new_context(sampled: Optional[bool] = None) -> TraceContext:
    """Mint a fresh trace at an ingress point. ``sampled=None`` makes
    the head-sampling decision from ``FLAGS_trace_sample_rate``."""
    trace_id = _gen_trace_id()
    if sampled is None:
        sampled = sample_decision(
            trace_id, float(_flag("FLAGS_trace_sample_rate", 0.0)))
    return TraceContext(trace_id, _gen_span_id(), sampled=sampled)


# ------------------------------------------------------------- ambient
_tls = threading.local()


def current_context() -> Optional[TraceContext]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Make ``ctx`` the ambient context for this thread (``submit`` /
    ``submit_generate`` pick it up)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def request_context() -> Optional[TraceContext]:
    """The context a request should be traced under: the ambient one
    when set, else a freshly sampled one when tracing is on
    (``FLAGS_trace_sample_rate > 0``), else None — the no-tracing fast
    path is one TLS read and one flag read."""
    ctx = current_context()
    if ctx is not None:
        return ctx
    if float(_flag("FLAGS_trace_sample_rate", 0.0)) > 0.0:
        return new_context()
    return None


# ------------------------------------------------------------- process
_proc_lock = threading.Lock()
_process_name: Optional[str] = None


def set_process_name(name: str):
    """Stamp every span this process records (router / replica-N /
    the bare pid by default) — the cross-process axis of the stitched
    view."""
    global _process_name
    with _proc_lock:
        _process_name = str(name)


def process_name() -> str:
    global _process_name
    with _proc_lock:
        if _process_name is None:
            _process_name = f"pid-{os.getpid()}"
        return _process_name


# ------------------------------------------------------------- spans
class Span:
    """One completed, typed unit of work inside a trace."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "stage",
                 "process", "pid", "tid", "start_unix_ns",
                 "duration_ms", "status", "attrs")

    def __init__(self, trace_id, span_id, parent_id, name, stage,
                 start_unix_ns, duration_ms, status="ok", attrs=None,
                 process=None, pid=None, tid=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.stage = stage
        self.process = process if process is not None \
            else process_name()
        self.pid = int(pid) if pid is not None else os.getpid()
        self.tid = int(tid) if tid is not None \
            else threading.get_ident()
        self.start_unix_ns = int(start_unix_ns)
        self.duration_ms = float(duration_ms)
        self.status = status
        self.attrs = dict(attrs) if attrs else {}

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "stage": self.stage, "process": self.process,
                "pid": self.pid, "tid": self.tid,
                "start_unix_ns": self.start_unix_ns,
                "duration_ms": round(self.duration_ms, 4),
                "status": self.status, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(d["trace_id"], d["span_id"],
                   d.get("parent_id", ""), d.get("name", ""),
                   d.get("stage", ""), d["start_unix_ns"],
                   d["duration_ms"], status=d.get("status", "ok"),
                   attrs=d.get("attrs"), process=d.get("process"),
                   pid=d.get("pid", 0), tid=d.get("tid", 0))


class SpanBuffer:
    """The flight recorder: a bounded, lock-guarded in-process ring of
    completed spans. Oldest spans are evicted past ``max_spans``;
    one trace is capped at ``max_per_trace`` spans (a long decode
    stream records its first N steps and counts the rest as dropped)
    so a single request cannot monopolize the recorder."""

    def __init__(self, max_spans: Optional[int] = None,
                 max_per_trace: Optional[int] = None):
        self._max = int(max_spans if max_spans is not None
                        else _flag("FLAGS_trace_buffer_spans", 4096))
        self._per_trace = int(
            max_per_trace if max_per_trace is not None
            else _flag("FLAGS_trace_max_spans_per_trace", 256))
        self._lock = threading.Lock()
        self._spans: deque = deque()
        self._per_trace_counts: Dict[str, int] = {}
        self._dropped = 0
        self._total = 0

    def __len__(self):
        with self._lock:
            return len(self._spans)

    @property
    def capacity(self) -> int:
        return self._max

    def add(self, span: Span):
        with self._lock:
            n = self._per_trace_counts.get(span.trace_id, 0)
            if n >= self._per_trace:
                self._dropped += 1
                return
            self._per_trace_counts[span.trace_id] = n + 1
            self._spans.append(span)
            self._total += 1
            while len(self._spans) > self._max:
                old = self._spans.popleft()
                c = self._per_trace_counts.get(old.trace_id, 1) - 1
                if c > 0:
                    self._per_trace_counts[old.trace_id] = c
                else:
                    self._per_trace_counts.pop(old.trace_id, None)

    def add_many(self, spans: Iterable[Span]):
        for s in spans:
            self.add(s)

    def snapshot(self, trace_id: Optional[str] = None,
                 min_duration_ms: Optional[float] = None
                 ) -> List[dict]:
        with self._lock:
            spans = list(self._spans)
        out = []
        for s in spans:
            if trace_id is not None and s.trace_id != trace_id:
                continue
            if min_duration_ms is not None and \
                    s.duration_ms < min_duration_ms:
                continue
            out.append(s.to_dict())
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"spans": len(self._spans), "capacity": self._max,
                    "max_per_trace": self._per_trace,
                    "dropped": self._dropped,
                    "total_recorded": self._total,
                    "traces": len(self._per_trace_counts)}

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._per_trace_counts.clear()
            self._dropped = 0
            self._total = 0


_default_lock = threading.Lock()
_default_buffer: Optional[SpanBuffer] = None


def default_buffer() -> SpanBuffer:
    """The process-wide flight recorder ``/tracez`` serves."""
    global _default_buffer
    with _default_lock:
        if _default_buffer is None:
            _default_buffer = SpanBuffer()
        return _default_buffer


def set_default_buffer(buf: Optional[SpanBuffer]
                       ) -> Optional[SpanBuffer]:
    """Swap the process-wide buffer (tests; ``None`` resets to a fresh
    one on next use). Returns the previous buffer."""
    global _default_buffer
    with _default_lock:
        prev, _default_buffer = _default_buffer, buf
    return prev


# ------------------------------------------------------------- record
def promote(ctx: TraceContext, reason: str = "",
            buffer: Optional[SpanBuffer] = None):
    """Tail promotion: flush this trace's parked spans into the
    recorder and record everything from here on, sampled or not —
    called on error / shed / deadline paths so failures are always
    traceable."""
    buf = buffer if buffer is not None else default_buffer()
    with ctx.state.lock:
        if ctx.state.promoted:
            return
        ctx.state.promoted = True
        pending, ctx.state.pending = ctx.state.pending, []
    for s in pending:
        if reason:
            s.attrs.setdefault("promoted", reason)
        buf.add(s)


def record_span(ctx: Optional[TraceContext], name: str, *,
                stage: str = "", start_unix_ns: int,
                duration_ms: float, attrs: Optional[dict] = None,
                status: str = "ok", root: bool = False,
                buffer: Optional[SpanBuffer] = None
                ) -> Optional[Span]:
    """Record one measured span under ``ctx`` (no-op when untraced).
    ``root=True`` records the span AS the context's own span id (the
    span this context was created for); otherwise a fresh child id is
    minted. ``status="error"`` promotes the trace."""
    if ctx is None:
        return None
    span = Span(ctx.trace_id,
                ctx.span_id if root else _gen_span_id(),
                ctx.parent_id if root else ctx.span_id,
                name, stage, start_unix_ns, duration_ms,
                status=status, attrs=attrs)
    buf = buffer if buffer is not None else default_buffer()
    if status == "error":
        promote(ctx, reason=str(attrs.get("error", "error"))
                if attrs else "error", buffer=buf)
    if ctx.recording:
        buf.add(span)
        return span
    with ctx.state.lock:
        cap = int(_flag("FLAGS_trace_max_spans_per_trace", 256))
        if len(ctx.state.pending) < cap:
            ctx.state.pending.append(span)
        else:
            ctx.state.dropped += 1
    return span


class _LiveSpan:
    """Handle yielded by ``start_span``: carries the child context for
    further nesting/propagation and collects attrs until exit."""

    __slots__ = ("ctx", "name", "stage", "attrs", "_t0_ns",
                 "_wall0_ns", "_buffer", "status")

    def __init__(self, ctx, name, stage, attrs, buffer):
        self.ctx = ctx
        self.name = name
        self.stage = stage
        self.attrs = dict(attrs) if attrs else {}
        self._buffer = buffer
        self._t0_ns = time.perf_counter_ns()
        self._wall0_ns = time.time_ns()
        self.status = "ok"

    def set_attr(self, key, value):
        self.attrs[key] = value

    def finish(self):
        dur_ms = (time.perf_counter_ns() - self._t0_ns) / 1e6
        record_span(self.ctx, self.name, stage=self.stage,
                    start_unix_ns=self._wall0_ns, duration_ms=dur_ms,
                    attrs=self.attrs, status=self.status, root=True,
                    buffer=self._buffer)


@contextmanager
def start_span(name: str, *, stage: str = "",
               ctx: Optional[TraceContext] = None,
               attrs: Optional[dict] = None,
               buffer: Optional[SpanBuffer] = None):
    """Open a live child span under ``ctx`` (default: the ambient
    context) and make its child context ambient for the block, so
    nested ``start_span`` / ``submit`` calls parent correctly. An
    escaping exception marks the span errored (which promotes the
    trace) and re-raises. Untraced: yields an inert handle."""
    parent = ctx if ctx is not None else current_context()
    if parent is None:
        yield _NOOP_SPAN
        return
    live = _LiveSpan(parent.child(), name, stage, attrs, buffer)
    with use_context(live.ctx):
        try:
            yield live
        except BaseException as e:
            live.status = "error"
            live.attrs.setdefault(
                "error", f"{type(e).__name__}: {e}")
            live.finish()
            raise
        live.finish()


class _NoopSpan:
    __slots__ = ()
    ctx = None
    status = "ok"

    def set_attr(self, key, value):
        pass

    def finish(self):
        pass


_NOOP_SPAN = _NoopSpan()


# ------------------------------------------------------------- views
def merge_span_dicts(*span_lists: Sequence[dict]) -> List[dict]:
    """Concatenate span-dict lists from several processes, de-duplicated
    by (trace_id, span_id) — the router's stitch primitive."""
    seen = set()
    out: List[dict] = []
    for spans in span_lists:
        for s in spans:
            key = (s.get("trace_id"), s.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
    return out


def group_traces(span_dicts: Sequence[dict],
                 trace_id: Optional[str] = None,
                 min_duration_ms: Optional[float] = None,
                 limit: Optional[int] = None) -> List[dict]:
    """Group span dicts into per-trace records (newest first). A
    trace's duration is its span envelope (earliest start to latest
    end) — the stitched cross-process view. ``min_duration_ms``
    filters on that envelope; ``trace_id`` on identity."""
    by_trace: Dict[str, List[dict]] = {}
    for s in span_dicts:
        by_trace.setdefault(s["trace_id"], []).append(s)
    traces = []
    for tid, spans in by_trace.items():
        if trace_id is not None and tid != trace_id:
            continue
        spans = sorted(spans, key=lambda s: (s["start_unix_ns"],
                                             s.get("span_id", "")))
        t0 = min(s["start_unix_ns"] for s in spans)
        t1 = max(s["start_unix_ns"] + s["duration_ms"] * 1e6
                 for s in spans)
        dur = (t1 - t0) / 1e6
        if min_duration_ms is not None and dur < min_duration_ms:
            continue
        traces.append({
            "trace_id": tid,
            "start_unix_ms": round(t0 / 1e6, 3),
            "duration_ms": round(dur, 3),
            "n_spans": len(spans),
            "processes": sorted({s.get("process", "") for s in spans}),
            "errored": any(s.get("status") == "error" for s in spans),
            "spans": spans,
        })
    traces.sort(key=lambda t: -t["start_unix_ms"])
    if limit is not None:
        traces = traces[:int(limit)]
    return traces


def tracez_payload(buffer: Optional[SpanBuffer] = None,
                   trace_id: Optional[str] = None,
                   min_duration_ms: Optional[float] = None,
                   limit: Optional[int] = 100,
                   extra_spans: Optional[Sequence[dict]] = None
                   ) -> dict:
    """The ``/tracez`` JSON document: recent traces (grouped, filtered)
    plus recorder stats and the exemplar table. ``extra_spans`` merges
    remote span dicts in (the router's fan-out view)."""
    buf = buffer if buffer is not None else default_buffer()
    spans = buf.snapshot(trace_id=trace_id)
    if extra_spans:
        spans = merge_span_dicts(spans, extra_spans)
    return {
        "process": process_name(),
        "traces": group_traces(spans, trace_id=trace_id,
                               min_duration_ms=min_duration_ms,
                               limit=limit),
        "buffer": buf.stats(),
        "exemplars": exemplars(),
    }


# ------------------------------------------------------------- chrome
def chrome_trace_events(span_dicts: Sequence[dict]) -> List[dict]:
    """Span dicts -> chrome-trace events in the profiler's export
    schema ("X" complete events + process_name metadata), so the fleet
    timeline and ``profiler.export_chrome_tracing`` output co-exist in
    one viewer."""
    events: List[dict] = []
    procs: Dict[int, str] = {}
    for s in span_dicts:
        pid = int(s.get("pid", 0))
        procs.setdefault(pid, s.get("process", f"pid-{pid}"))
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s.get("parent_id", ""),
                "status": s.get("status", "ok")}
        args.update(s.get("attrs") or {})
        events.append({
            "name": s.get("name", ""),
            "cat": s.get("stage") or "span",
            "ph": "X",
            "ts": s["start_unix_ns"] / 1e3,      # chrome wants us
            "dur": s["duration_ms"] * 1e3,
            "pid": pid,
            "tid": int(s.get("tid", 0)),
            "args": args,
        })
    for pid, name in sorted(procs.items()):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": name}})
    return events


def export_chrome_trace(path: str,
                        span_dicts: Optional[Sequence[dict]] = None,
                        include_profiler: bool = False,
                        buffer: Optional[SpanBuffer] = None) -> int:
    """Write spans (default: the whole flight recorder) as a chrome
    trace. ``include_profiler=True`` splices the profiler's python-side
    RecordEvent spans into the same file (the port's profiler has no host
    tracer yet, so it raises). Returns the event count."""
    if span_dicts is None:
        buf = buffer if buffer is not None else default_buffer()
        span_dicts = buf.snapshot()
    events = chrome_trace_events(span_dicts)
    if include_profiler:
        raise NotImplementedError(
            "splicing the profiler's host spans needs the profiler's host "
            "tracer, which waits for ROADMAP queue 1 item 5d")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)


# ------------------------------------------------------------- exemplars
# Bucket bounds mirror the registry's default ms histogram buckets so
# an exemplar maps 1:1 onto the Prometheus ``le`` the operator is
# staring at.
from .registry import DEFAULT_MS_BUCKETS  # noqa: E402 (cycle-free)


class _ExemplarStore:
    """Latest trace id observed per (metric, le-bucket) — bounded by
    construction: #metrics x #buckets entries."""

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BUCKETS):
        self._bounds = tuple(sorted(float(b) for b in bounds))
        self._lock = threading.Lock()
        self._latest: Dict[str, Dict[str, dict]] = {}

    def _le(self, value: float) -> str:
        for b in self._bounds:
            if value <= b:
                return str(b)
        return "+Inf"

    def record(self, metric: str, value_ms: float, trace_id: str):
        entry = {"trace_id": trace_id,
                 "value_ms": round(float(value_ms), 4),
                 "unix_ms": round(time.time() * 1e3, 1)}
        le = self._le(float(value_ms))
        with self._lock:
            self._latest.setdefault(metric, {})[le] = entry

    def snapshot(self, metric: Optional[str] = None) -> dict:
        with self._lock:
            if metric is not None:
                return dict(self._latest.get(metric, {}))
            return {m: dict(v) for m, v in self._latest.items()}

    def clear(self):
        with self._lock:
            self._latest.clear()


_exemplars = _ExemplarStore()


def record_exemplar(metric: str, value_ms: float, trace_id: str):
    """Attach ``trace_id`` as the latest exemplar of ``metric``'s
    latency bucket for ``value_ms`` — the p99-bucket-to-trace link."""
    _exemplars.record(metric, value_ms, trace_id)


def exemplars(metric: Optional[str] = None) -> dict:
    """``{metric: {le: {trace_id, value_ms, unix_ms}}}`` (or one
    metric's table)."""
    return _exemplars.snapshot(metric)


def clear_exemplars():
    _exemplars.clear()


def spans(trace_id: Optional[str] = None) -> List[dict]:
    """The default recorder's spans as dicts, oldest first (or one
    trace's)."""
    return default_buffer().snapshot(trace_id=trace_id)
