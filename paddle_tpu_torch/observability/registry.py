"""Typed metric registry (the part of ``paddle_tpu/observability/registry.py``
that the serving metrics and ``framework.monitor`` use).

Three metric families (``Counter``, ``Gauge``, ``Histogram``) with
Prometheus-style label sets, the bounded-window percentile estimator
``PercentileWindow`` (the serving snapshot's percentiles) and a
process-wide ``MetricRegistry`` that owns the families. The reference's scrape-time collectors and its exposition (text,
JSON, HTTP) wait for the operations plane (ROADMAP queue 1 item 5b). Pure
standard library, as the reference's.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "PercentileWindow", "default_registry", "DEFAULT_MS_BUCKETS"]

# Millisecond-scaled default buckets (the stack's latencies are ms-sized).
DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q / 100.0 * len(sorted_vals)) - 1))
    return float(sorted_vals[k])


class PercentileWindow:
    """Bounded window of recent observations with nearest-rank
    percentiles: at most ``maxlen`` samples and, with ``max_age_s``, only
    samples younger than that. ``now`` is injected for deterministic
    tests. Not locked: callers synchronize around it."""

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

    def snapshot(self, qs: Sequence[float] = (50, 95, 99)) -> dict:
        vals = sorted(self.values())
        out = {"count": len(vals)}
        for q in qs:
            out[f"p{int(q)}"] = _nearest_rank(vals, q)
        out["max"] = vals[-1] if vals else 0.0
        return out


class _Family:
    """A named metric with a fixed label-name set; each distinct label
    value tuple is one child."""

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
        """Child for these labels, or None (never creates one)."""
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


class Counter(_Family):
    """Monotonic count (``inc`` takes any numeric delta: it also backs
    ``framework.monitor``'s ``stat_add``)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        self.observe_many((v,))

    def observe_many(self, vals):
        with self._lock:
            for v in vals:
                v = float(v)
                self._counts[bisect.bisect_left(self._bounds, v)] += 1
                self._sum += v
                self._count += 1

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, +Inf last."""
        with self._lock:
            out, running = [], 0
            for ub, c in zip(self._bounds, self._counts):
                running += c
                out.append((ub, running))
            out.append((float("inf"), running + self._counts[-1]))
            return out


class Histogram(_Family):
    """Cumulative buckets, a sum and a count per child (the reference's
    per-child percentile window is not kept: the serving snapshot keeps
    its own)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),  # noqa: A002
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = tuple(b for b in bounds if not math.isinf(b))

    def _new_child(self):
        return _HistogramChild(self._bounds)


class MetricRegistry:
    """Owns metric families; creation is get-or-create and idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()

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
                  buckets=DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)


_default_lock = threading.Lock()
_default: Optional[MetricRegistry] = None


def default_registry() -> MetricRegistry:
    """The process-wide registry (``framework.monitor``, serving)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry()
        return _default
