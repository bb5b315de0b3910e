"""CompileCache: persistent first-dispatch records keyed by stable
fingerprints (the port of ``paddle_tpu/compile_cache/cache.py``).

The reference serializes compiled XLA executables (and a StableHLO
fallback tier) so a fresh process skips the trace and the compile. The
port compiles no program at run time: PyTorch runs eagerly, and the one
compiled artifact, the hand-written kernel library, is already built once
per source hash and reused (``ops/_build.py``). CUDA graphs, cuBLAS's
algorithm choices and the caching allocator's segments do not outlive the
process. What does outlive it, and what this cache keeps, is a
signature's **first-dispatch record**: the FLOPs, bytes and memory that
``observability.xstats.measure`` reads on a signature's first dispatch at
each site (``serving``, ``generate_*``, ``train_step``). That pass counts
every op under a dispatch mode and costs up to seconds of host time on a
large model; it is a pure function of the code, the model's layout, the
signature, the flags and the toolchain, which is what the key covers
(``fingerprint.cache_key``). A hit loads the record and skips the
measurement; the dispatch itself runs exactly as without the cache, so
its outputs are bit for bit the same. The one payload kind is
``"record"``; the warmup manifests (``manifest.py``) replay the
signatures before traffic.

Every lookup/store reports into the ``paddle_compile_cache_*`` metric
families on the default observability registry, with the reference's
names and labels:

    paddle_compile_cache_hits_total{site=}      persistent-cache hits
    paddle_compile_cache_misses_total{site=}    lookups that measured
    paddle_compile_cache_errors_total{site=,kind=}  corrupt / unwritable
    paddle_compile_cache_fallbacks_total{site=} stores on a second tier;
                                                always 0 in the port,
                                                whose one tier (records)
                                                every device has
    paddle_compile_cache_evictions_total        LRU evictions
    paddle_compile_cache_stored_total{site=,kind=}  entries written
    paddle_compile_cache_bytes                  on-disk size
    paddle_compile_cache_entries                on-disk entry count
    paddle_compile_cache_load_ms{site=}         read + unpickle latency

Enabled by pointing ``FLAGS_compile_cache_dir`` at a directory (empty =
disabled, the default); ``FLAGS_compile_cache_max_bytes`` bounds the
LRU store.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple

from ..observability.registry import default_registry
from .store import CacheStore

__all__ = ["CompileCache", "default_cache", "reset_default_cache", "stats"]

KIND_RECORD = "record"

# The record's fields: the measurement's numbers that depend only on what
# the key covers. The allocator's absolute readings depend on what the
# process held before the dispatch, so a record keeps the dispatch's own
# allocation and its temporary peak above the start instead.
RECORD_FIELDS = ("flops", "kernel_flops", "bytes_accessed",
                 "bytes_accessed_bound", "transcendentals", "source",
                 "measure_host_ms", "alloc_delta_bytes", "temp_bytes")


class _Metrics:
    """The paddle_compile_cache_* families (process-wide, shared by
    every CompileCache instance)."""

    def __init__(self, registry=None):
        reg = registry or default_registry()
        self.hits = reg.counter(
            "paddle_compile_cache_hits_total",
            "persistent compile-cache hits (a stored first-dispatch "
            "record was loaded instead of measured)", ("site",))
        self.misses = reg.counter(
            "paddle_compile_cache_misses_total",
            "persistent compile-cache misses (a fresh measurement ran)",
            ("site",))
        self.errors = reg.counter(
            "paddle_compile_cache_errors_total",
            "cache entries evicted as corrupt / failed writes",
            ("site", "kind"))
        self.fallbacks = reg.counter(
            "paddle_compile_cache_fallbacks_total",
            "stores on a second payload tier; the port has one tier "
            "(records), so this stays 0", ("site",))
        self.evictions = reg.counter(
            "paddle_compile_cache_evictions_total",
            "entries removed by LRU size bounding")
        self.stored = reg.counter(
            "paddle_compile_cache_stored_total",
            "entries written, by payload kind", ("site", "kind"))
        self.bytes = reg.gauge(
            "paddle_compile_cache_bytes", "total on-disk cache size")
        self.entries = reg.gauge(
            "paddle_compile_cache_entries", "on-disk cache entry count")
        self.load_ms = reg.histogram(
            "paddle_compile_cache_load_ms",
            "read + load latency of cache hits", ("site",))


_metrics_lock = threading.Lock()
_metrics: Optional[_Metrics] = None


def _get_metrics() -> _Metrics:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            _metrics = _Metrics()
        return _metrics


def record_of(analysis: Optional[dict]) -> Optional[dict]:
    """The storable part of a measurement (``RECORD_FIELDS``)."""
    if analysis is None:
        return None
    return {k: analysis.get(k) for k in RECORD_FIELDS if k in analysis}


class CompileCache:
    """Disk-backed cache of first-dispatch records.

    ``load`` returns a stored record (or None); ``store`` writes one;
    ``get_or_compile`` is the one-stop wrapper the dispatch sites use. All
    failure modes degrade to a fresh measurement — nothing in here may
    raise into a serving loop."""

    def __init__(self, directory: str, max_bytes: int = 0, registry=None):
        self.store_backend = CacheStore(directory, max_bytes)
        self.metrics = _Metrics(registry) if registry is not None \
            else _get_metrics()
        self._refresh_gauges()

    @property
    def directory(self) -> str:
        return self.store_backend.directory

    def _refresh_gauges(self):
        entries = self.store_backend.entries()
        self.metrics.entries.set(len(entries))
        self.metrics.bytes.set(sum(size for _, size, _ in entries))

    # ------------------------------------------------------------ load
    def load(self, key: str, site: str = "default"):
        """The stored record for ``key``, or None. Counts a hit or a
        miss; a corrupt entry is evicted and counted as an error + miss."""
        return self.load_ex(key, site=site)[0]

    def load_ex(self, key: str, site: str = "default"):
        """``load`` plus the stored payload kind of a hit —
        ``(record, "record")`` or ``(None, None)`` — so ``get_or_compile``
        can record the tier in xstats provenance."""
        t0 = time.perf_counter()
        try:
            record = self.store_backend.get(key)
        except Exception:  # noqa: BLE001 - corrupt record: already evicted
            self.metrics.errors.labels(site=site, kind="corrupt").inc()
            record = None
        payload, kind = None, None
        if record is not None:
            if record["kind"] == KIND_RECORD \
                    and isinstance(record["payload"], dict):
                payload, kind = dict(record["payload"]), KIND_RECORD
            else:
                # another package's executable, or a payload of the wrong
                # type under a valid key: evict, measure afresh
                self.store_backend.remove(key)
                self.metrics.errors.labels(site=site,
                                           kind="deserialize").inc()
        if payload is None:
            self.metrics.misses.labels(site=site).inc()
            return None, None
        self.metrics.hits.labels(site=site).inc()
        self.metrics.load_ms.labels(site=site).observe(
            (time.perf_counter() - t0) * 1e3)
        return payload, kind

    # ----------------------------------------------------------- store
    def store(self, key: str, record: Optional[dict],
              meta: Optional[dict] = None,
              site: str = "default") -> Optional[str]:
        """Write ``record`` under ``key``; returns the stored kind or
        None (nothing to store, or the write failed)."""
        if record is None:
            return None
        try:
            before = {k for k, _, _ in self.store_backend.entries()}
            self.store_backend.put(key, {"kind": KIND_RECORD,
                                         "payload": dict(record),
                                         "meta": meta})
            after = {k for k, _, _ in self.store_backend.entries()}
            evicted = len(before - after - {key})
            if evicted:
                self.metrics.evictions.inc(evicted)
        except Exception:  # noqa: BLE001 - a full/readonly disk must not
            # break the dispatch; the record is still used live
            self.metrics.errors.labels(site=site, kind="write").inc()
            return None
        self.metrics.stored.labels(site=site, kind=KIND_RECORD).inc()
        self._refresh_gauges()
        return KIND_RECORD

    # -------------------------------------------------------- combined
    def get_or_compile(self, key: str, build: Callable, *,
                       site: str = "default", meta: Optional[dict] = None,
                       xstats_meta: Optional[dict] = None
                       ) -> Tuple[Optional[dict], bool]:
        """Load ``key`` or ``build()`` (returning the first-dispatch
        record: it runs the measured dispatch), store it, and return
        ``(record, was_hit)``.

        ``xstats_meta`` (``{"kind", "signature", "fingerprint",
        "spec_hash", "provenance", "analysis"}``, all optional) registers
        the signature in the xstats registry with hit/miss/tier provenance
        added here — the one chokepoint every cache site flows through. On
        a miss the entry takes ``xstats_meta["analysis"]`` when given (the
        full measurement, absolute allocator readings included), else the
        record; the registered entry is left in ``xstats_meta["entry"]``
        for the caller to note its later dispatches."""
        record, tier = self.load_ex(key, site=site)
        if record is not None:
            self._register_xstats(site, key, record, hit=True, tier=tier,
                                  xstats_meta=xstats_meta)
            return record, True
        # a miss measures: the measured dispatch is compile badput on the
        # goodput ledger (a frame, so an enclosing step frame gives up
        # its share instead of double-counting)
        from ..observability.goodput import default_ledger
        with default_ledger().timed("compile"):
            record = build()
        stored = self.store(key, record, meta=meta, site=site)
        self._register_xstats(site, key, record, hit=False,
                              tier=stored or (KIND_RECORD if record
                                              else None),
                              xstats_meta=xstats_meta)
        return record, False

    @staticmethod
    def _register_xstats(site: str, key: str, record, *, hit: bool,
                         tier: Optional[str],
                         xstats_meta: Optional[dict]):
        """Best-effort xstats registration of a cache-mediated
        signature."""
        try:
            from ..observability import xstats
            if not xstats.enabled():
                return
            m = xstats_meta or {}
            prov = dict(m.get("provenance") or {})
            prov["cache"] = "hit" if hit else "miss"
            if tier:
                prov["tier"] = tier
            signature = m.get("signature") or ((("key",), key),)
            analysis = record if hit else (m.get("analysis") or record)
            m["entry"] = xstats.register_executable(
                site, signature, kind=m.get("kind"),
                fingerprint=m.get("fingerprint"),
                spec_hash=m.get("spec_hash"), provenance=prov,
                analysis=dict(analysis) if analysis else None)
        except Exception:  # noqa: BLE001 - observability must never
            pass           # break the dispatch


# ------------------------------------------------------- default cache
_default_lock = threading.Lock()
_default: Optional[Tuple[Tuple[str, int], CompileCache]] = None


def default_cache() -> Optional[CompileCache]:
    """The process-wide cache configured by ``FLAGS_compile_cache_dir``
    / ``FLAGS_compile_cache_max_bytes``; None when disabled (empty dir,
    the default). Re-reads the flags so tests and long-lived processes
    can repoint it with ``set_flags``."""
    from ..framework.flags import flag_value
    global _default
    directory = str(flag_value("FLAGS_compile_cache_dir") or "")
    if not directory:
        return None
    max_bytes = int(flag_value("FLAGS_compile_cache_max_bytes"))
    cfg = (directory, max_bytes)
    with _default_lock:
        if _default is None or _default[0] != cfg:
            _default = (cfg, CompileCache(directory, max_bytes))
        return _default[1]


def reset_default_cache():
    """Drop the memoized default cache (tests that swap directories)."""
    global _default
    with _default_lock:
        _default = None


def stats() -> dict:
    """Process-wide compile-cache accounting, summed over sites — the
    numbers ``tools/bench_coldstart.py`` cross-checks against a scraped
    ``/metrics`` page."""
    m = _get_metrics()

    def total(counter):
        return int(sum(child.value for _, child in counter.items()))

    return {
        "hits": total(m.hits),
        "misses": total(m.misses),
        "errors": total(m.errors),
        "fallbacks": total(m.fallbacks),
        "evictions": total(m.evictions),
        "stored": total(m.stored),
        "bytes": int(m.bytes.value),
        "entries": int(m.entries.value),
    }
