"""Serving metrics: per-server metrics and a named registry (the port of
``paddle_tpu/serving/metrics.py``).

Every recording lands in typed metric families on the process-wide registry
(``observability.registry.default_registry()``), under the reference's
family names (``paddle_serving_requests_total``, ``paddle_serving_latency_ms``,
``paddle_serving_stage_ms``, ...); counter bumps also mirror into
``framework.monitor`` as ``serving_<server>_*``, and the server wraps batch
stages in ``profiler.RecordEvent`` spans and records a traced request's
latency as the exemplar of its ``paddle_serving_latency_ms`` bucket
(``tracing.record_exemplar``, served in ``/tracez``). ``snapshot()`` keeps the
reference's JSON schema::

    {"server": str,
     "counters": {"submitted", "completed", "rejected", "timed_out",
                  "cancelled", "failed", "batches"},
     "queue": {"depth", "capacity", "peak_depth"},
     "batch_size_hist": {"<rows>": count, ...},
     "padding": {"real_elements", "padded_elements", "waste_ratio"},
     "latency_ms": {"count", "p50", "p95", "p99", "max"},
     "stage_ms": {"count",
                  "assembly" | "dispatch" | "device_wait" | "fetch" |
                  "host" | "device": {"p50", "p95", "p99", "max"},
                  "host_fraction"},
     "compile_cache": {"hits", "misses", "signatures"}}

``stage_ms`` is the per-batch split of the pipelined executor: ``assembly``
(the copy into the staging buffers), ``dispatch`` (the host-to-device copy
and the program's launches, which return before the card finishes),
``device_wait`` (the completion thread's wait on the batch's CUDA event,
which also covers the device-to-host copy enqueued behind the program) and
``fetch`` (slicing the host outputs per request). ``host`` =
assembly + dispatch + fetch, ``device`` = device_wait, and ``host_fraction``
is sum(host) / sum(host + device) over the window. ``compile_cache`` counts
every dispatch: without a compile cache (``FLAGS_compile_cache_dir``
empty), the first run of each (signature, padded rows) in this server is a
miss and every later one a hit, as the reference counts its XLA compiles
(on the card a first run pays the kernels' first launches, the allocator's
growth and cuBLAS's choices). With a cache set, a first run whose
first-dispatch record the cache supplied counts as a hit, so a server
warmed from a warm directory reads 0 misses; ``signatures`` counts the
distinct (signature, padded rows) either way.

Percentiles come from ``observability.registry.PercentileWindow`` (the
``window`` most recent samples, nearest rank).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Optional

from ..framework import monitor
from ..observability.registry import PercentileWindow, default_registry

__all__ = ["ServingMetrics", "register", "get", "unregister",
           "all_snapshots"]

_COUNTERS = ("submitted", "completed", "rejected", "timed_out",
             "cancelled", "failed", "batches")

_STAGES = ("assembly", "dispatch", "device_wait", "fetch", "host",
           "device")

_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class ServingMetrics:
    """Thread-safe metric sink for one server, backed by registry
    families. Instantiating a name resets that server's label slice in
    the shared families (a restarted server starts from zero, matching
    the pre-registry behavior)."""

    def __init__(self, name: str = "default", window: int = 2048,
                 registry=None):
        self.name = name
        self._lock = threading.Lock()
        reg = self._registry = registry or default_registry()

        self._f_events = reg.counter(
            "paddle_serving_requests_total",
            "serving request lifecycle events per server",
            ("server", "event"))
        self._f_latency = reg.histogram(
            "paddle_serving_latency_ms",
            "end-to-end request latency (submit -> future resolved)",
            ("server",))
        self._f_stage = reg.histogram(
            "paddle_serving_stage_ms",
            "per-batch pipeline stage durations (host = assembly+"
            "dispatch+fetch, device = device_wait)",
            ("server", "stage"))
        self._f_batch_rows = reg.histogram(
            "paddle_serving_batch_rows",
            "real rows per coalesced device batch", ("server",),
            buckets=_ROW_BUCKETS)
        self._f_queue = reg.gauge(
            "paddle_serving_queue_depth", "current request-queue depth",
            ("server",))
        self._f_capacity = reg.gauge(
            "paddle_serving_queue_capacity", "bounded queue capacity",
            ("server",))
        self._f_peak = reg.gauge(
            "paddle_serving_queue_peak_depth",
            "highest queue depth observed", ("server",))
        self._f_padding = reg.counter(
            "paddle_serving_padding_elements_total",
            "input elements by kind: real (caller-supplied) vs padded "
            "(elements the bucketed device batch actually carries)",
            ("server", "kind"))
        self._f_compile = reg.counter(
            "paddle_serving_compile_total",
            "serving compile-cache lookups by result",
            ("server", "result"))
        self._f_signatures = reg.gauge(
            "paddle_serving_compile_signatures",
            "distinct compiled (signature, padded_rows) entries",
            ("server",))

        # a fresh ServingMetrics owns its server's slice from zero
        for fam in (self._f_events, self._f_latency, self._f_stage,
                    self._f_batch_rows, self._f_queue, self._f_capacity,
                    self._f_peak, self._f_padding, self._f_compile,
                    self._f_signatures):
            fam.clear(server=name)

        self._events = {c: self._f_events.labels(server=name, event=c)
                        for c in _COUNTERS}
        self._h_latency = self._f_latency.labels(server=name)
        self._h_stages = {s: self._f_stage.labels(server=name, stage=s)
                          for s in _STAGES}
        self._h_batch_rows = self._f_batch_rows.labels(server=name)
        self._c_real = self._f_padding.labels(server=name, kind="real")
        self._c_padded = self._f_padding.labels(server=name,
                                                kind="padded")
        self._c_hits = self._f_compile.labels(server=name, result="hit")
        self._c_misses = self._f_compile.labels(server=name,
                                                result="miss")

        # bounded windows for the snapshot percentiles (per instance so
        # each server honors ITS window size; the family windows back
        # the shared /metrics exposition)
        self._latency = PercentileWindow(int(window))
        self._stages = {k: PercentileWindow(int(window))
                        for k in _STAGES}
        self._batch_hist: Dict[int, int] = {}
        self._queue_depth = 0
        self._queue_capacity = 0
        self._peak_depth = 0
        self._real_elements = 0
        self._padded_elements = 0
        self._signatures = set()

    # ---- recording ----
    def _event_child(self, name: str):
        child = self._events.get(name)
        if child is None:
            with self._lock:
                child = self._events.get(name)
                if child is None:
                    child = self._events[name] = self._f_events.labels(
                        server=self.name, event=name)
        return child

    def count(self, name: str, n: int = 1):
        self._event_child(name).inc(n)
        monitor.stat_add(f"serving_{self.name}_{name}", n)

    def queue_depth(self, depth: int, capacity: int):
        with self._lock:
            self._queue_depth = depth
            self._queue_capacity = capacity
            self._peak_depth = max(self._peak_depth, depth)
            peak = self._peak_depth
        self._f_queue.labels(server=self.name).set(depth)
        self._f_capacity.labels(server=self.name).set(capacity)
        self._f_peak.labels(server=self.name).set(peak)

    def observe_batch(self, rows: int, real_elements: int,
                      padded_elements: int):
        with self._lock:
            self._batch_hist[rows] = self._batch_hist.get(rows, 0) + 1
            self._real_elements += real_elements
            self._padded_elements += padded_elements
        self._events["batches"].inc()
        self._h_batch_rows.observe(rows)
        self._c_real.inc(real_elements)
        self._c_padded.inc(padded_elements)
        monitor.stat_add(f"serving_{self.name}_batches", 1)

    def observe_latency(self, ms: float):
        with self._lock:
            self._latency.observe(float(ms))
        self._h_latency.observe(ms)

    def observe_latency_many(self, ms_list):
        """Bulk latency append: one lock acquisition per batch instead
        of one per request (the completion stage resolves whole batches
        at a time)."""
        ms_list = [float(m) for m in ms_list]
        with self._lock:
            self._latency.extend(ms_list)
        self._h_latency.observe_many(ms_list)

    def observe_stage_times(self, assembly_ms: float, dispatch_ms: float,
                            device_wait_ms: float, fetch_ms: float):
        """Per-batch pipeline stage durations; host = everything the
        host CPU did (assembly + dispatch + fetch), device = time spent
        waiting on device compute."""
        vals = {"assembly": float(assembly_ms),
                "dispatch": float(dispatch_ms),
                "device_wait": float(device_wait_ms),
                "fetch": float(fetch_ms),
                "host": float(assembly_ms + dispatch_ms + fetch_ms),
                "device": float(device_wait_ms)}
        with self._lock:
            for k, v in vals.items():
                self._stages[k].observe(v)
        for k, v in vals.items():
            self._h_stages[k].observe(v)

    def observe_compile(self, hit: bool, signature=None):
        (self._c_hits if hit else self._c_misses).inc()
        if signature is not None:
            with self._lock:
                if signature in self._signatures:
                    return
                self._signatures.add(signature)
                n = len(self._signatures)
            self._f_signatures.labels(server=self.name).set(n)

    # ---- export ----
    def snapshot(self) -> dict:
        with self._lock:
            counters = {c: 0 for c in _COUNTERS}
            counters.update({ev: int(child.value)
                             for ev, child in self._events.items()})
            padded = self._padded_elements
            real = self._real_elements
            lat = self._latency.snapshot()
            return {
                "server": self.name,
                "counters": counters,
                "queue": {"depth": self._queue_depth,
                          "capacity": self._queue_capacity,
                          "peak_depth": self._peak_depth},
                "batch_size_hist": {str(k): v for k, v in
                                    sorted(self._batch_hist.items())},
                "padding": {
                    "real_elements": real,
                    "padded_elements": padded,
                    "waste_ratio": (padded - real) / padded if padded
                    else 0.0},
                "latency_ms": lat,
                "stage_ms": self._stage_snapshot(),
                "compile_cache": {"hits": int(self._c_hits.value),
                                  "misses": int(self._c_misses.value),
                                  "signatures": len(self._signatures)},
            }

    def _stage_snapshot(self) -> dict:
        """Per-stage percentiles + host fraction (lock held)."""
        out = {"count": len(self._stages["host"])}
        for name, window in self._stages.items():
            snap = window.snapshot()
            snap.pop("count")
            out[name] = snap
        host = self._stages["host"].sum()
        device = self._stages["device"].sum()
        out["host_fraction"] = host / (host + device) \
            if host + device else 0.0
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def export_json(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))


# ---- named registry (one entry per live server) ----
_reg_lock = threading.Lock()
_registry: Dict[str, ServingMetrics] = {}


def register(m: ServingMetrics) -> ServingMetrics:
    with _reg_lock:
        _registry[m.name] = m
    return m


def get(name: str) -> Optional[ServingMetrics]:
    with _reg_lock:
        return _registry.get(name)


def unregister(name: str):
    with _reg_lock:
        _registry.pop(name, None)


def all_snapshots() -> dict:
    with _reg_lock:
        servers = list(_registry.values())
    return {m.name: m.snapshot() for m in servers}
