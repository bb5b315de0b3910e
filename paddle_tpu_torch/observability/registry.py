"""Typed metric registry, the single surface every subsystem of the port
reports into (the port of ``paddle_tpu/observability/registry.py``).

Three metric families (``Counter``, ``Gauge``, ``Histogram``) with
Prometheus-style label sets, the bounded-window percentile estimator
``PercentileWindow`` (shared with ``serving.metrics``), and a
``MetricRegistry`` that owns the families plus scrape-time collectors.
Exposition (Prometheus text, JSON, HTTP) lives in ``exposition.py`` and
``httpd.py``, so this module stays standard-library only and import-light:
``framework.monitor`` imports it before most of the package exists.

Time is injected: ``PercentileWindow`` and ``Histogram`` take a ``now``
callable (default ``time.monotonic``), so age-bounded windows are
deterministic under test and immune to wall-clock jumps.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "PercentileWindow",
    "default_registry", "sanitize_metric_name", "DEFAULT_MS_BUCKETS",
]

# Millisecond-scaled default buckets (the stack's latencies are ms-sized;
# Prometheus' stock seconds buckets would collapse everything into one).
DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Coerce an arbitrary string into a legal Prometheus metric name."""
    name = _INVALID_CHARS.sub("_", str(name))
    if not name or not _NAME_RE.match(name):
        name = "_" + name
    return name


def _nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample: serving and
    the registry agree on every quantile."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q / 100.0 * len(sorted_vals)) - 1))
    return float(sorted_vals[k])


class PercentileWindow:
    """Bounded window of recent observations with nearest-rank
    percentiles. Bounded two ways: at most ``maxlen`` samples, and (when
    ``max_age_s`` is set) only samples younger than that — so a
    long-running server's p99 tracks current behavior, not its whole
    life. ``now`` is injected for deterministic tests.

    Not internally locked: callers (Histogram children, ServingMetrics)
    synchronize around it, matching the deques it replaces."""

    __slots__ = ("_dq", "_now", "max_age_s")

    def __init__(self, maxlen: int = 2048, max_age_s: Optional[float] = None,
                 now: Callable[[], float] = time.monotonic):
        self._dq = deque(maxlen=int(maxlen))
        self._now = now
        self.max_age_s = max_age_s

    def _prune(self):
        if self.max_age_s is None:
            return
        cutoff = self._now() - self.max_age_s
        dq = self._dq
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def observe(self, value: float):
        self._dq.append((self._now(), float(value)))
        self._prune()

    def extend(self, values: Iterable[float]):
        t = self._now()
        self._dq.extend((t, float(v)) for v in values)
        self._prune()

    def values(self) -> List[float]:
        self._prune()
        return [v for _, v in self._dq]

    def __len__(self):
        self._prune()
        return len(self._dq)

    def sum(self) -> float:
        return float(sum(self.values()))

    def max(self) -> float:
        vals = self.values()
        return float(max(vals)) if vals else 0.0

    def percentile(self, q: float) -> float:
        return _nearest_rank(sorted(self.values()), q)

    def snapshot(self, qs: Sequence[float] = (50, 95, 99)) -> dict:
        vals = sorted(self.values())
        out = {"count": len(vals)}
        for q in qs:
            out[f"p{int(q)}"] = _nearest_rank(vals, q)
        out["max"] = vals[-1] if vals else 0.0
        return out

    def clear(self):
        self._dq.clear()


# --------------------------------------------------------------- families
class _Family:
    """A named metric with a fixed label-name set; each distinct label
    value tuple is one child. With an empty label set the family proxies
    to its single anonymous child (``Counter("x").inc()``)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: "OrderedDict[Tuple, object]" = OrderedDict()

    # -- child construction (subclass hook)
    def _new_child(self):
        raise NotImplementedError

    def _key(self, args, kwargs) -> Tuple:
        if args and kwargs:
            raise ValueError("pass labels positionally or by name, not both")
        if kwargs:
            if set(kwargs) != set(self.labelnames):
                raise ValueError(
                    f"{self.name} expects labels {self.labelnames}, "
                    f"got {tuple(kwargs)}")
            return tuple(str(kwargs[ln]) for ln in self.labelnames)
        if len(args) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects {len(self.labelnames)} label "
                f"values, got {len(args)}")
        return tuple(str(a) for a in args)

    def labels(self, *args, **kwargs):
        key = self._key(args, kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def get(self, *args, **kwargs):
        """Child for these labels, or None — never creates (so read-only
        probes like monitor.stat_get don't mint empty series)."""
        key = self._key(args, kwargs)
        with self._lock:
            return self._children.get(key)

    def remove(self, *args, **kwargs):
        key = self._key(args, kwargs)
        with self._lock:
            self._children.pop(key, None)

    def clear(self, **label_filter):
        """Drop children; with kwargs, only those matching the partial
        label set (``family.clear(server="x")`` wipes one server's
        slice)."""
        with self._lock:
            if not label_filter:
                self._children.clear()
                return
            idx = {ln: i for i, ln in enumerate(self.labelnames)}
            for ln in label_filter:
                if ln not in idx:
                    raise ValueError(f"unknown label {ln!r}")
            dead = [k for k in self._children
                    if all(k[idx[ln]] == str(v)
                           for ln, v in label_filter.items())]
            for k in dead:
                del self._children[k]

    def items(self) -> List[Tuple[Tuple, object]]:
        with self._lock:
            return list(self._children.items())

    def collect(self) -> List[Tuple[Dict[str, str], object]]:
        """(labels_dict, child) pairs for exposition."""
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in self.items()]

    def label_values(self) -> List[Tuple]:
        with self._lock:
            return list(self._children)


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0


class Counter(_Family):
    """Monotonic count. ``inc`` tolerates any numeric delta because it
    also backs ``framework.monitor``'s permissive STAT_ADD view."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n=1):
        return self.labels().inc(n)

    @property
    def value(self):
        return self.labels().value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None

    def set(self, v):
        with self._lock:
            self._fn = None
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    def set_function(self, fn: Callable[[], float]):
        """Value is computed at read time (scrape) instead of pushed."""
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        fn = self._fn
        if fn is not None:
            try:
                return fn()
            except Exception:  # noqa: BLE001 - a broken probe must not
                return float("nan")  # take down the whole scrape
        return self._value


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v):
        self.labels().set(v)

    def inc(self, n=1):
        self.labels().inc(n)

    def dec(self, n=1):
        self.labels().dec(n)

    def set_function(self, fn):
        self.labels().set_function(fn)

    @property
    def value(self):
        return self.labels().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count", "window")

    def __init__(self, bounds, window_len, max_age_s, now):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self.window = PercentileWindow(window_len, max_age_s, now)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._sum += v
            self._count += 1
            self.window.observe(v)

    def observe_many(self, vals):
        with self._lock:
            for v in vals:
                v = float(v)
                self._counts[bisect.bisect_left(self._bounds, v)] += 1
                self._sum += v
                self._count += 1
                self.window.observe(v)

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, +Inf last — the
        Prometheus histogram wire shape."""
        with self._lock:
            out, running = [], 0
            for ub, c in zip(self._bounds, self._counts):
                running += c
                out.append((ub, running))
            out.append((float("inf"), running + self._counts[-1]))
            return out

    def percentile(self, q: float) -> float:
        with self._lock:
            return self.window.percentile(q)

    def window_snapshot(self, qs=(50, 95, 99)) -> dict:
        with self._lock:
            return self.window.snapshot(qs)

    def window_sum(self) -> float:
        with self._lock:
            return self.window.sum()

    def window_count(self) -> int:
        with self._lock:
            return len(self.window)

    def reset(self):
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._count = 0
            self.window.clear()


class Histogram(_Family):
    """Cumulative buckets (Prometheus exposition) plus a bounded
    ``PercentileWindow`` per child (live p50/p95/p99, the serving
    snapshot schema)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),  # noqa: A002
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
                 window: int = 2048, max_age_s: Optional[float] = None,
                 now: Callable[[], float] = time.monotonic):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = tuple(b for b in bounds if not math.isinf(b))
        self._window_len = int(window)
        self._max_age_s = max_age_s
        self._now = now

    def _new_child(self):
        return _HistogramChild(self._bounds, self._window_len,
                               self._max_age_s, self._now)

    def observe(self, v):
        self.labels().observe(v)


# --------------------------------------------------------------- registry
class MetricRegistry:
    """Owns metric families (creation is get-or-create and idempotent)
    plus scrape-time collectors — callables invoked at ``collect()`` to
    refresh pull-style gauges (device memory, queue depths) just before
    exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()
        self._collectors: List[Callable[["MetricRegistry"], None]] = []

    # -- family management
    def register(self, family: _Family) -> _Family:
        with self._lock:
            existing = self._families.get(family.name)
            if existing is not None:
                if type(existing) is not type(family):
                    raise ValueError(
                        f"metric {family.name!r} already registered as "
                        f"{existing.kind}, not {family.kind}")
                return existing
            self._families[family.name] = family
            return family

    def unregister(self, name: str):
        with self._lock:
            self._families.pop(name, None)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def _get_or_create(self, cls, name, help, labelnames, **kw):  # noqa: A002
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {cls.kind}")
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> Counter:  # noqa: A002
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:  # noqa: A002
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),  # noqa: A002
                  buckets=DEFAULT_MS_BUCKETS, window=2048,
                  max_age_s=None, now=time.monotonic) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, window=window,
                                   max_age_s=max_age_s, now=now)

    # -- collectors
    def register_collector(self, fn, name: Optional[str] = None):
        """Idempotent by ``name`` (default: the function's qualname), so
        installers can run on every telemetry-server start."""
        key = name or getattr(fn, "__qualname__", repr(fn))
        with self._lock:
            if any(k == key for k, _ in self._collectors):
                return fn
            self._collectors.append((key, fn))
        return fn

    def unregister_collector(self, name: str):
        with self._lock:
            self._collectors = [(k, f) for k, f in self._collectors
                                if k != name]

    def collect(self) -> List[_Family]:
        """Run collectors (a broken one is skipped, never fatal) and
        return families in registration order."""
        with self._lock:
            collectors = list(self._collectors)
            families = list(self._families.values())
        for _, fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - scrape must survive any
                pass           # single broken probe
        return families


_default_lock = threading.Lock()
_default: Optional[MetricRegistry] = None


def default_registry() -> MetricRegistry:
    """The process-wide registry every built-in subsystem reports into
    (framework.monitor, serving, the scheduler, SLOs, step profiles)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry()
        return _default
