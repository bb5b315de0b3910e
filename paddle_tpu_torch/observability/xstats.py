"""Executable cost and roofline observability (the port of
``paddle_tpu/observability/xstats.py``): the ``/execz`` registry, the MFU
join with the step profiler, and on-demand or anomaly-triggered profiles
(``/profilez``).

**Registry.** The reference registers an executable where XLA compiles it
and reads XLA's cost model. The port runs eager PyTorch and compiles no
program, so its registration point is **the first dispatch of a
signature** at each site: ``TrainStep`` (site ``train_step``), the
``CachedDecoder`` entry points (``generate_prefill``, ``generate_decode``,
``generate_chunked``, ``generate_verify``) and the ``Predictor``'s
assembled batches (``serving``). That dispatch, and only that one, runs
under :func:`measure`:

- FLOPs: ``torch.utils.flop_counter``'s formulas (those
  ``FlopCounterMode`` applies) over torch's ops, plus the hand-written
  kernels' own tally for the ``ctypes`` launches the counter cannot see
  (``flops`` of ``ops/cuda_attention*.py`` and
  ``ops/cuda_paged_attention.py``), so each kernel counts once and the
  plain route's matmuls once;
- bytes accessed: the sum of every torch op's operand and result bytes
  (views excluded) plus the kernels' tallied operand bytes: an upper bound
  without fusion, which ``/execz`` says (``bytes_accessed_bound``);
- memory: the caching allocator's allocated bytes before and after the
  dispatch and the dispatch's own allocation (``alloc_delta_bytes``, after
  less before), and its peak where it can be read without resetting the
  process's peak statistics (only when the dispatch raised the process's
  peak; otherwise ``peak_bytes`` and ``temp_bytes``, the peak above the
  start, are None).

With no compile cache (``FLAGS_compile_cache_dir`` empty, the default) an
entry's provenance reads ``{"tier": "eager"}``. With one, a site that
names its identity (``identity=``) asks the cache at a signature's first
dispatch in each object: a hit registers the stored record with
``{"cache": "hit", "tier": "record"}`` and skips the measurement, a miss
measures, stores the record and registers ``{"cache": "miss", "tier":
"record"}`` (``compile_cache/cache.py``). A record holds only what the key
determines: FLOPs, bytes, the host ms the measurement took, the dispatch's
own allocation and its temporary peak above the start — never the
allocator's absolute readings, which depend on what the process held
before, so a hit's entry has no ``alloc_before_bytes``,
``alloc_after_bytes`` or ``peak_bytes``. Later dispatches only bump the
entry's counters.

**MFU / roofline join.** Each step-profiler envelope's kind (train,
prefill, decode, verify, serving) meets the most recently dispatched entry
of that kind::

    paddle_mfu{kind=}            FLOPs / (step wall time x peak FLOP/s)
    paddle_exec_bw_util{kind=}   bytes / (step wall time x peak bytes/s)
    paddle_exec_flops{kind=}     FLOPs of the live entry
    paddle_exec_bytes_accessed{kind=}

Peaks come from ``FLAGS_device_peak_flops`` /
``FLAGS_device_peak_bytes_per_s``, else from a table keyed by the CUDA
device's name (the H100's dense bf16 989e12 FLOP/s and 3.35e12 B/s), else
0 (unknown: the MFU gauges stay unset).

**Profiles.** ``GET /profilez?duration_ms=`` runs one bounded
``torch.profiler`` capture (CPU and CUDA activities) and returns its
chrome-trace document, also kept gzipped in a bounded on-disk ring
(``FLAGS_profile_dir``, ``FLAGS_profile_ring``), rate-limited by
``FLAGS_profile_min_interval_s``; ``GET /profilez`` lists the ring. A
capture is refused with :class:`ProfilerBusyError` while another profiler
session is active in the process. With ``FLAGS_profile_on_anomaly`` armed,
a straggler or a numerics anomaly triggers exactly one rate-limited
background capture whose artifact records the anomaly span's trace id.
"""
from __future__ import annotations

import gzip
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .registry import default_registry

__all__ = [
    "ExecEntry", "ExecRegistry", "ProfileRing", "ProfilerBusyError",
    "default_exec_registry", "default_profile_ring",
    "register_executable", "note_dispatch", "on_step_envelope",
    "on_anomaly", "enabled", "device_peaks", "execz_payload",
    "profilez_payload", "capture_profile", "wait_captures",
    "reset_for_tests", "SITE_KINDS", "signature_of", "measure",
    "observed_call",
]


def _flag(name, default):
    from ..framework.flags import flag_value
    try:
        return flag_value(name)
    except KeyError:
        return default


# enabled() and device_peaks() sit on per-step paths; both are functions
# of the flag set, so they cache on flags_generation (any set_flags call
# invalidates)
_enabled_cache: Tuple[Optional[int], bool] = (None, True)
_peaks_cache: Tuple[Optional[int], Optional[dict]] = (None, None)


def _flags_generation() -> int:
    from ..framework.flags import flags_generation
    return flags_generation()


def enabled() -> bool:
    global _enabled_cache
    gen = _flags_generation()
    if _enabled_cache[0] == gen:
        return _enabled_cache[1]
    val = bool(_flag("FLAGS_xstats_enable", True))
    _enabled_cache = (gen, val)
    return val


# Which MFU/roofline step kind a site's entries belong to; the step
# profiler's envelopes use the same vocabulary, so the join is a lookup.
SITE_KINDS: Dict[str, str] = {
    "train_step": "train",
    "generate_prefill": "prefill",
    "generate_chunked": "prefill",
    "generate_decode": "decode",
    "generate_verify": "verify",
    "serving": "serving",
    "jit": "jit",
}

# Peak dense FLOP/s and memory bandwidth by CUDA device name (a substring
# of torch.cuda.get_device_name()): the H100 SXM's dense bf16 tensor-core
# rate and HBM3 bandwidth, the numbers chip_smoke.py and bench.py use.
# Host CPUs vary too much to pretend: set the flags there.
_DEVICE_PEAKS: Dict[str, Tuple[float, float]] = {
    "H100": (989e12, 3.35e12),
}


def device_peaks() -> dict:
    """``{"flops", "bytes_per_s", "source", "platform", "device"}``:
    explicit flags first, then the device-name table, else 0 (unknown).
    Cached per flags generation."""
    global _peaks_cache
    gen = _flags_generation()
    if _peaks_cache[0] == gen and _peaks_cache[1] is not None:
        return _peaks_cache[1]
    out = _device_peaks_uncached()
    _peaks_cache = (gen, out)
    return out


def _device_name() -> Optional[str]:
    import torch
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 - peaks must resolve without a card
        pass
    return None


def _device_peaks_uncached() -> dict:
    flops = float(_flag("FLAGS_device_peak_flops", 0.0))
    bps = float(_flag("FLAGS_device_peak_bytes_per_s", 0.0))
    source = "flag" if (flops or bps) else "table"
    name = _device_name()
    if not (flops and bps):
        t_flops, t_bps = next(
            (v for k, v in _DEVICE_PEAKS.items() if name and k in name),
            (0.0, 0.0))
        flops = flops or t_flops
        bps = bps or t_bps
    if not (flops or bps):
        source = "unknown"
    return {"flops": flops, "bytes_per_s": bps, "source": source,
            "platform": "gpu" if name else "cpu", "device": name}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def signature_of(tree) -> tuple:
    """Canonical ((shape, dtype), ...) signature of the tensors and arrays
    in a nested structure (lists, tuples, dicts): the registry's per-site
    entry key."""
    from torch.utils._pytree import tree_leaves
    return tuple(
        (tuple(int(d) for d in getattr(a, "shape", ())),
         _dtype_name(getattr(a, "dtype", type(a).__name__)))
        for a in tree_leaves(tree))


def _itemsize(dtype: str) -> int:
    import numpy as np
    import torch
    t = getattr(torch, dtype, None)
    if isinstance(t, torch.dtype):
        return t.itemsize
    return np.dtype(dtype).itemsize


def _sig_arg_bytes(signature) -> int:
    """Total operand bytes a signature implies (the memory floor of an
    entry)."""
    total = 0
    for shape, dtype in signature:
        try:
            n = 1
            for d in shape:
                n *= int(d)
            total += n * _itemsize(dtype)
        except Exception:  # noqa: BLE001 - a tag entry or exotic dtype
            pass           # just does not count
    return int(total)


# ------------------------------------------------------- measurement
def _kernel_tally() -> Tuple[float, float]:
    """(FLOPs, bytes) the hand-written kernels' wrappers have tallied in
    this process so far."""
    from ..ops import cuda_attention as ca
    from ..ops import cuda_attention_bwd as cab
    from ..ops import cuda_paged_attention as cpa
    return (ca.flops + sum(cab.flops.values()) + cpa.flops,
            ca.bytes_moved + cab.bytes_moved + cpa.bytes_moved)


def _nbytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


def _counter():
    """One dispatch mode counting each op's FLOPs as ``FlopCounterMode``
    does (its formulas; an op without one is decomposed where it can be,
    as under ``inference_mode``, where ``aten.linear`` arrives whole), but
    without its module tracking, and each executed non-view op's operand
    and result bytes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            formula = flop_registry.get(func._overloadpacket)
            if formula is None and func is not torch.ops.prim.device.default:
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if not getattr(func, "is_view", False):
                self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            return out

    return Counter()


def measure(call: Callable, device=None):
    """Run ``call()`` once under the counters; returns ``(its result,
    analysis)``. ``device``: the CUDA device whose allocator to read (None
    or a CPU device: no memory numbers). A counter that cannot be set up
    leaves the call to run plainly (analysis None); ``call`` runs exactly
    once either way."""
    import torch
    try:
        counter = _counter()
        dev = torch.device(device) if device is not None else None
        cuda = dev is not None and dev.type == "cuda"
        k_flops0, k_bytes0 = _kernel_tally()
        if cuda:
            mem0 = torch.cuda.memory_allocated(dev)
            peak0 = torch.cuda.max_memory_allocated(dev)
    except Exception:  # noqa: BLE001 - garnish: the call must still run
        return call(), None
    t0 = time.perf_counter()
    with counter:
        out = call()
    host_ms = (time.perf_counter() - t0) * 1e3
    k_flops1, k_bytes1 = _kernel_tally()
    ana = {"flops": float(counter.flops) + (k_flops1 - k_flops0),
           "kernel_flops": k_flops1 - k_flops0,
           "bytes_accessed": float(counter.bytes) + (k_bytes1 - k_bytes0),
           "bytes_accessed_bound": True,
           "transcendentals": 0.0,
           "source": "eager_first_dispatch",
           "measure_host_ms": round(host_ms, 4)}
    if cuda:
        mem1 = torch.cuda.memory_allocated(dev)
        peak1 = torch.cuda.max_memory_allocated(dev)
        ana.update({"alloc_before_bytes": int(mem0),
                    "alloc_after_bytes": int(mem1),
                    "alloc_delta_bytes": int(mem1 - mem0),
                    "peak_bytes": int(peak1) if peak1 > peak0 else None,
                    "temp_bytes": int(peak1 - mem0) if peak1 > peak0
                    else None})
    return out, ana


class ExecEntry:
    """One registered signature: (site, signature) identity plus the cost
    and memory numbers and provenance the /execz page serves."""

    __slots__ = ("site", "kind", "signature", "fingerprint", "spec_hash",
                 "provenance", "created_unix_ms", "dispatches",
                 "last_dispatch_unix_ms", "analysis", "analysis_error",
                 "sig_arg_bytes")

    def __init__(self, site: str, signature: tuple, *,
                 kind: Optional[str] = None,
                 fingerprint: Optional[str] = None,
                 spec_hash: Optional[str] = None,
                 provenance: Optional[dict] = None,
                 analysis: Optional[dict] = None):
        self.site = site
        self.kind = kind or SITE_KINDS.get(site, "other")
        self.signature = signature
        self.fingerprint = fingerprint
        self.spec_hash = spec_hash
        self.provenance = dict(provenance or {})
        self.created_unix_ms = time.time_ns() // 1_000_000
        self.dispatches = 0
        self.last_dispatch_unix_ms = None
        self.analysis: Optional[dict] = analysis
        self.analysis_error: Optional[str] = None
        self.sig_arg_bytes = _sig_arg_bytes(signature)

    def roofline(self, peaks: Optional[dict] = None) -> dict:
        """Arithmetic intensity against the device's ridge point."""
        ana = self.analysis or {}
        flops = ana.get("flops", 0.0)
        ba = ana.get("bytes_accessed", 0.0)
        out = {"intensity": round(flops / ba, 4) if ba else None,
               "classification": "unknown"}
        peaks = peaks if peaks is not None else device_peaks()
        if ba and flops and peaks["flops"] and peaks["bytes_per_s"]:
            ridge = peaks["flops"] / peaks["bytes_per_s"]
            out["ridge"] = round(ridge, 4)
            out["classification"] = ("compute_bound"
                                     if flops / ba >= ridge
                                     else "memory_bound")
        return out

    def payload(self, peaks: Optional[dict] = None) -> dict:
        return {
            "site": self.site,
            "kind": self.kind,
            "signature": [[list(s), d] for s, d in self.signature],
            "fingerprint": self.fingerprint,
            "spec_hash": self.spec_hash,
            "provenance": self.provenance,
            "created_unix_ms": self.created_unix_ms,
            "dispatches": self.dispatches,
            "last_dispatch_unix_ms": self.last_dispatch_unix_ms,
            "sig_arg_bytes": self.sig_arg_bytes,
            "analysis": self.analysis,
            "analysis_error": self.analysis_error,
            "roofline": self.roofline(peaks),
        }


class ExecRegistry:
    """Process-wide bounded registry of signatures keyed by (site,
    signature), with per-kind live-entry tracking for the MFU join."""

    def __init__(self, max_entries: Optional[int] = None, registry=None):
        self._max = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[tuple, ExecEntry] = {}
        self._order: List[tuple] = []        # registration order (LRU)
        self._kind_latest: Dict[str, ExecEntry] = {}
        self._kind_state: Dict[str, dict] = {}
        # cached metric-label children: the per-step paths must not pay a
        # labels() lookup per call
        self._site_dispatch_children: Dict[str, object] = {}
        self._kind_gauge_children: Dict[str, tuple] = {}
        reg = registry or default_registry()
        self._c_registered = reg.counter(
            "paddle_exec_registered_total",
            "executables registered in the xstats registry", ("site",))
        self._c_dispatches = reg.counter(
            "paddle_exec_dispatches_total",
            "dispatches of registered executables", ("site",))
        self._c_evicted = reg.counter(
            "paddle_exec_evicted_total",
            "registry entries evicted by the size bound")
        self._c_analysis_errors = reg.counter(
            "paddle_exec_analysis_errors_total",
            "cost/memory analysis attempts that raised", ("site",))
        self._g_entries = reg.gauge(
            "paddle_exec_entries", "live xstats registry entries")
        self._g_flops = reg.gauge(
            "paddle_exec_flops",
            "cost-model FLOPs of the live executable per step kind",
            ("kind",))
        self._g_bytes = reg.gauge(
            "paddle_exec_bytes_accessed",
            "cost-model bytes accessed of the live executable per "
            "step kind", ("kind",))
        self._g_mfu = reg.gauge(
            "paddle_mfu",
            "model FLOPs utilization per step kind: registry FLOPs / "
            "(step wall time x device peak FLOP/s)", ("kind",))
        self._g_bw = reg.gauge(
            "paddle_exec_bw_util",
            "bandwidth utilization per step kind: registry bytes "
            "accessed / (step wall time x device peak bytes/s)",
            ("kind",))

    def _bound(self) -> int:
        if self._max is not None:
            return int(self._max)
        return int(_flag("FLAGS_xstats_max_entries", 512))

    def register(self, site: str, signature: tuple, *,
                 kind: Optional[str] = None,
                 fingerprint: Optional[str] = None,
                 spec_hash: Optional[str] = None,
                 provenance: Optional[dict] = None,
                 analysis: Optional[dict] = None) -> ExecEntry:
        """Insert (or refresh) the entry for (site, signature). A
        re-registration of a live key merges provenance and fills what
        the entry lacks; it never duplicates."""
        key = (site, signature)
        evicted = 0
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                if provenance:
                    ent.provenance.update(provenance)
                if analysis is not None and ent.analysis is None:
                    ent.analysis = analysis
                if fingerprint and not ent.fingerprint:
                    ent.fingerprint = fingerprint
                if spec_hash and not ent.spec_hash:
                    ent.spec_hash = spec_hash
                self._kind_latest[ent.kind] = ent
                return ent
            ent = ExecEntry(site, signature, kind=kind,
                            fingerprint=fingerprint, spec_hash=spec_hash,
                            provenance=provenance, analysis=analysis)
            self._entries[key] = ent
            self._order.append(key)
            self._kind_latest[ent.kind] = ent
            bound = self._bound()
            while len(self._order) > bound:
                old = self._order.pop(0)
                dropped = self._entries.pop(old, None)
                if dropped is not None:
                    evicted += 1
                    for k2, v2 in list(self._kind_latest.items()):
                        if v2 is dropped:
                            self._kind_latest.pop(k2, None)
            self._g_entries.set(len(self._entries))
        self._c_registered.labels(site=site).inc()
        if evicted:
            self._c_evicted.inc(evicted)
        return ent

    def note_dispatch(self, entry: ExecEntry):
        """One dispatch of ``entry``: bumps counters and makes it the live
        entry of its kind for the MFU join."""
        with self._lock:
            entry.dispatches += 1
            entry.last_dispatch_unix_ms = time.time_ns() // 1_000_000
            self._kind_latest[entry.kind] = entry
            child = self._site_dispatch_children.get(entry.site)
            if child is None:
                child = self._site_dispatch_children[entry.site] = \
                    self._c_dispatches.labels(site=entry.site)
        child.inc()

    def lookup(self, site: str, signature: tuple) -> Optional[ExecEntry]:
        with self._lock:
            return self._entries.get((site, signature))

    def entries(self) -> List[ExecEntry]:
        with self._lock:
            return [self._entries[k] for k in self._order
                    if k in self._entries]

    def on_step_envelope(self, env: dict):
        """Join one step-profiler envelope with the live entry of its
        kind: set the paddle_mfu / bandwidth gauges and fold the achieved
        numbers into the per-kind state /execz serves."""
        kind = env.get("kind")
        wall_ms = env.get("wall_ms")
        if not kind or not wall_ms:
            return
        with self._lock:
            entry = self._kind_latest.get(kind)
        if entry is None:
            return
        ana = entry.analysis
        if ana is None:
            return
        wall_s = float(wall_ms) / 1e3
        peaks = device_peaks()
        state = {"wall_ms": round(float(wall_ms), 4),
                 "flops": ana.get("flops", 0.0),
                 "bytes_accessed": ana.get("bytes_accessed", 0.0),
                 "achieved_flops_per_s":
                 round(ana.get("flops", 0.0) / wall_s, 2),
                 "roofline": entry.roofline(peaks)["classification"],
                 "site": entry.site}
        children = self._kind_gauge_children.get(kind)
        if children is None:
            children = (self._g_flops.labels(kind=kind),
                        self._g_bytes.labels(kind=kind),
                        self._g_mfu.labels(kind=kind),
                        self._g_bw.labels(kind=kind))
            with self._lock:
                self._kind_gauge_children[kind] = children
        g_flops, g_bytes, g_mfu, g_bw = children
        g_flops.set(ana.get("flops", 0.0))
        g_bytes.set(ana.get("bytes_accessed", 0.0))
        if peaks["flops"]:
            mfu = ana.get("flops", 0.0) / (wall_s * peaks["flops"])
            g_mfu.set(mfu)
            state["mfu"] = round(mfu, 6)
            env["mfu"] = round(mfu, 6)
        if peaks["bytes_per_s"]:
            bw = ana.get("bytes_accessed", 0.0) / (
                wall_s * peaks["bytes_per_s"])
            g_bw.set(bw)
            state["bw_util"] = round(bw, 6)
        with self._lock:
            prev = self._kind_state.get(kind)
            n = (prev or {}).get("steps", 0) + 1
            state["steps"] = n
            if prev is not None and "wall_ms_ewma" in prev:
                state["wall_ms_ewma"] = round(
                    prev["wall_ms_ewma"]
                    + 0.1 * (float(wall_ms) - prev["wall_ms_ewma"]), 4)
            else:
                state["wall_ms_ewma"] = round(float(wall_ms), 4)
            self._kind_state[kind] = state

    def execz_payload(self, compute: bool = True) -> dict:
        """The /execz page. ``compute`` is accepted for the reference's
        surface: every entry's numbers were measured at its first
        dispatch, so there is nothing left to compute at scrape time."""
        del compute
        peaks = device_peaks()
        entries = [e.payload(peaks) for e in self.entries()]
        sites: Dict[str, dict] = {}
        for e in entries:
            s = sites.setdefault(e["site"], {"entries": 0,
                                             "dispatches": 0,
                                             "flops": 0.0})
            s["entries"] += 1
            s["dispatches"] += e["dispatches"]
            s["flops"] = max(s["flops"],
                             (e["analysis"] or {}).get("flops", 0.0))
        with self._lock:
            kinds = {k: dict(v) for k, v in self._kind_state.items()}
        return {"peaks": peaks, "entries": entries, "sites": sites,
                "kinds": kinds, "n_entries": len(entries)}

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._order.clear()
            self._kind_latest.clear()
            self._kind_state.clear()
            self._g_entries.set(0)


# ----------------------------------------------------------- profiling
class ProfilerBusyError(RuntimeError):
    """A capture was asked for while another profiler session is active
    in this process."""


def _profiler_active() -> bool:
    import torch
    try:
        return bool(torch.autograd._profiler_enabled())
    except Exception:  # noqa: BLE001
        return False


class ProfileRing:
    """Bounded on-disk ring of profile captures.

    One capture = a bounded-duration ``torch.profiler`` session (CPU and,
    with a card, CUDA activities) exported as chrome-trace events, merged
    with the span flight recorder's window, kept as one gzipped chrome
    trace. Captures are rate-limited (``FLAGS_profile_min_interval_s``)
    and single-flight."""

    def __init__(self, directory: Optional[str] = None, registry=None):
        self._dir_override = directory
        self._lock = threading.Lock()
        self._artifacts: List[dict] = []
        self._last_capture_t: Optional[float] = None
        self._in_flight = False
        self._seq = 0
        self._threads: List[threading.Thread] = []
        reg = registry or default_registry()
        self._c_captures = reg.counter(
            "paddle_profile_captures_total",
            "completed profile captures by trigger reason", ("reason",))
        self._c_rate_limited = reg.counter(
            "paddle_profile_rate_limited_total",
            "capture requests refused by the rate limit or an "
            "in-flight capture")

    def directory(self) -> str:
        d = self._dir_override or str(_flag("FLAGS_profile_dir", "") or "")
        if not d:
            d = os.path.join(tempfile.gettempdir(),
                             f"paddle_tpu_torch_profilez_{os.getpid()}")
        os.makedirs(d, mode=0o700, exist_ok=True)
        return d

    def _try_begin(self, now: float) -> bool:
        min_interval = float(_flag("FLAGS_profile_min_interval_s", 30.0))
        with self._lock:
            if self._in_flight:
                return False
            if self._last_capture_t is not None and \
                    now - self._last_capture_t < min_interval:
                return False
            self._in_flight = True
            self._last_capture_t = now
            self._seq += 1
            return True

    def capture(self, duration_ms: float, *, reason: str = "manual",
                trace_id: Optional[str] = None
                ) -> Optional[Tuple[dict, dict]]:
        """Run one bounded capture; returns ``(meta, chrome_doc)``, or
        None when rate-limited or another capture is in flight. Raises
        :class:`ProfilerBusyError` while another profiler session is
        active."""
        if _profiler_active():
            raise ProfilerBusyError(
                "another profiler session is active in this process")
        if not self._try_begin(time.monotonic()):
            self._c_rate_limited.inc()
            return None
        try:
            return self._run_capture(duration_ms, reason, trace_id)
        finally:
            with self._lock:
                self._in_flight = False

    def _run_capture(self, duration_ms, reason, trace_id):
        import torch
        from torch.profiler import ProfilerActivity, profile
        duration_ms = max(1.0, min(
            float(duration_ms), float(_flag("FLAGS_profile_max_ms",
                                            2000.0))))
        start_unix_ns = time.time_ns()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        events: List[dict] = []
        fd, tpath = tempfile.mkstemp(prefix="torchtrace-", suffix=".json",
                                     dir=self.directory())
        os.close(fd)
        try:
            with profile(activities=acts) as prof:
                time.sleep(duration_ms / 1e3)
            prof.export_chrome_trace(tpath)
            with open(tpath, encoding="utf-8") as f:
                doc = json.load(f)
            evs = doc.get("traceEvents", doc) if isinstance(doc, dict) \
                else doc
            events.extend(e for e in evs or [] if isinstance(e, dict))
        finally:
            try:
                os.remove(tpath)
            except OSError:
                pass
        events.extend(self._window_spans(start_unix_ns))
        with self._lock:
            seq = self._seq
        meta = {
            "id": f"capture-{start_unix_ns // 1_000_000}-{seq}",
            "reason": reason,
            "trace_id": trace_id,
            "duration_ms": duration_ms,
            "start_unix_ms": start_unix_ns // 1_000_000,
            "events": len(events),
        }
        doc = {"traceEvents": events, "paddle_profilez": meta}
        path = os.path.join(self.directory(),
                            meta["id"] + ".trace.json.gz")
        blob = json.dumps(doc).encode("utf-8")
        with gzip.open(path, "wb") as f:
            f.write(blob)
        meta["path"] = path
        meta["bytes"] = len(blob)
        ring = int(_flag("FLAGS_profile_ring", 8))
        stale: List[dict] = []
        with self._lock:
            self._artifacts.append(dict(meta))
            while len(self._artifacts) > max(ring, 1):
                stale.append(self._artifacts.pop(0))
        for old in stale:
            try:
                os.remove(old["path"])
            except OSError:
                pass
        self._c_captures.labels(reason=reason).inc()
        return meta, doc

    @staticmethod
    def _window_spans(start_unix_ns: int) -> List[dict]:
        """Flight-recorder spans that started inside the capture window,
        as chrome events."""
        try:
            from . import tracing
            payload = tracing.tracez_payload(limit=200)
            spans = [s for t in payload.get("traces", [])
                     for s in t.get("spans", [])
                     if s.get("start_unix_ns", 0) >= start_unix_ns]
            return tracing.chrome_trace_events(spans)
        except Exception:  # noqa: BLE001
            return []

    def trigger_anomaly(self, trace_id: Optional[str],
                        env: Optional[dict] = None
                        ) -> Optional[threading.Thread]:
        """Arm-gated, rate-limited background capture for an anomaly. The
        rate-limit slot is claimed here, synchronously, so a burst spawns
        exactly one capture thread; a capture while another profiler
        session is active is skipped."""
        if not bool(_flag("FLAGS_profile_on_anomaly", False)):
            return None
        if _profiler_active() or not self._try_begin(time.monotonic()):
            self._c_rate_limited.inc()
            return None
        duration = float(_flag("FLAGS_profile_anomaly_ms", 500.0))

        def run():
            try:
                self._run_capture(duration, "anomaly", trace_id)
            except Exception:  # noqa: BLE001 - a capture bug must not
                pass           # leak into the anomaly's thread
            finally:
                with self._lock:
                    self._in_flight = False

        t = threading.Thread(target=run, name="profilez-anomaly",
                             daemon=True)
        with self._lock:
            self._threads.append(t)
            self._threads = [th for th in self._threads
                             if th.is_alive() or th is t]
        t.start()
        return t

    def wait_captures(self, timeout: float = 10.0):
        """Join outstanding background captures."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def artifacts(self) -> List[dict]:
        with self._lock:
            return [dict(a) for a in self._artifacts]

    def profilez_payload(self) -> dict:
        return {
            "dir": self.directory(),
            "artifacts": self.artifacts(),
            "armed_on_anomaly": bool(_flag("FLAGS_profile_on_anomaly",
                                           False)),
            "min_interval_s": float(_flag("FLAGS_profile_min_interval_s",
                                          30.0)),
            "max_ms": float(_flag("FLAGS_profile_max_ms", 2000.0)),
            "anomaly_ms": float(_flag("FLAGS_profile_anomaly_ms", 500.0)),
        }

    def clear(self):
        with self._lock:
            arts, self._artifacts = self._artifacts, []
            self._last_capture_t = None
        for a in arts:
            try:
                os.remove(a.get("path", ""))
            except OSError:
                pass


# ----------------------------------------------------- module surface
_default_lock = threading.Lock()
_default_registry: Optional[ExecRegistry] = None
_default_ring: Optional[ProfileRing] = None


def default_exec_registry() -> ExecRegistry:
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = ExecRegistry()
        return _default_registry


def default_profile_ring() -> ProfileRing:
    global _default_ring
    with _default_lock:
        if _default_ring is None:
            _default_ring = ProfileRing()
        return _default_ring


def reset_for_tests():
    """Fresh registry and ring (the old ring's artifacts are removed)."""
    global _default_registry, _default_ring
    with _default_lock:
        reg, _default_registry = _default_registry, None
        ring, _default_ring = _default_ring, None
    if reg is not None:
        reg.clear()
    if ring is not None:
        ring.clear()


def register_executable(site: str, signature: tuple, **kw
                        ) -> Optional[ExecEntry]:
    """Site entry point; None when xstats is off. Never raises: a
    registry bug must not break a dispatch."""
    if not enabled():
        return None
    try:
        return default_exec_registry().register(site, signature, **kw)
    except Exception:  # noqa: BLE001
        return None


def note_dispatch(entry: Optional[ExecEntry]):
    if entry is None or not enabled():
        return
    try:
        default_exec_registry().note_dispatch(entry)
    except Exception:  # noqa: BLE001 - hot path, never raise
        pass


_MEMO_GEN = "__flags_generation__"
_NO_CACHE = object()


def _site_cache():
    """The configured compile cache, or None (the flag read first: the
    cache package is imported only when a directory is set)."""
    if not str(_flag("FLAGS_compile_cache_dir", "") or ""):
        return None
    from ..compile_cache import default_cache
    return default_cache()


def observed_call(memo: dict, key, site: str, call: Callable, *,
                  signature_fn: Callable[[], tuple],
                  kind: Optional[str] = None,
                  fingerprint: Optional[Callable[[], str]] = None,
                  device=None,
                  identity: Optional[Callable[[], Optional[str]]] = None,
                  outcome: Optional[dict] = None, mesh=None):
    """Run ``call()`` as one dispatch of ``site``. A caller's dispatches
    of ``key`` after its first are only noted (``memo``, cleared when
    ``set_flags`` moves ``flags_generation()``). At the first, with a
    compile cache configured and ``identity()`` (the site's model
    identity) not None, the cache answers: a hit registers the stored
    record and ``call()`` runs unmeasured; a miss runs ``call()`` under
    :func:`measure` and stores the record. Without a cache, the first
    dispatch of a signature (``signature_fn()``) in the process is
    measured and registered (provenance tier ``eager``), and other
    callers' of a registered signature are only noted. With xstats off,
    just ``call()``. ``outcome`` (a dict) receives ``outcome[site]``:
    "hit" or "miss" when this dispatch asked the cache, else None.
    ``mesh`` (a live serving mesh, or None) joins the cache key."""
    if outcome is not None:
        outcome[site] = None
    if not enabled():
        return call()
    from ..framework.flags import flags_generation
    gen = flags_generation()
    if memo.get(_MEMO_GEN) != gen:
        memo.clear()
        memo[_MEMO_GEN] = gen
    ent = memo.get(key)
    if ent is None:
        try:
            cache = _site_cache() if identity is not None else None
        except Exception:  # noqa: BLE001 - a broken cache never fails
            cache = None   # the dispatch
        if cache is not None:
            out = _cached_call(cache, memo, key, site, call,
                               signature_fn=signature_fn, kind=kind,
                               fingerprint=fingerprint, device=device,
                               identity=identity, outcome=outcome,
                               mesh=mesh)
            if out is not _NO_CACHE:
                return out
        try:
            sig = signature_fn()
            ent = default_exec_registry().lookup(site, sig)
        except Exception:  # noqa: BLE001 - observability is garnish
            sig, ent = None, None
        if ent is not None and ent.analysis is not None:
            memo[key] = ent
        else:
            ent = None
    if ent is not None:
        out = call()
        note_dispatch(ent)
        return out
    out, ana = measure(call, device)
    try:
        ent = register_executable(
            site, sig, kind=kind,
            fingerprint=fingerprint() if fingerprint else None,
            provenance={"tier": "eager"}, analysis=ana)
    except Exception:  # noqa: BLE001 - observability is garnish
        ent = None
    if ent is not None:
        memo[key] = ent
        note_dispatch(ent)
    return out


def _cached_call(cache, memo, key, site, call, *, signature_fn, kind,
                 fingerprint, device, identity, outcome, mesh=None):
    """The first dispatch of ``key`` in this object, through the compile
    cache (``observed_call``). ``call()`` runs exactly once: measured on
    a miss, plainly on a hit; an error it raises propagates. Returns
    ``_NO_CACHE`` without running it when no key can be formed."""
    import torch
    try:
        ident = identity()
        if ident is None:
            return _NO_CACHE
        sig = signature_fn()
        from ..compile_cache import cache_key
        from ..compile_cache.cache import record_of
        ckey, parts = cache_key(ident, None, mesh=mesh, extra={
            "site": site,
            "device": (torch.device(device).type if device is not None
                       else "cpu"),
            "signature": [[list(s), d] for s, d in sig]})
        meta = {"kind": kind, "signature": sig,
                "fingerprint": fingerprint() if fingerprint else None}
    except Exception:  # noqa: BLE001 - no key: the uncached path
        return _NO_CACHE
    box = {}

    def build():
        try:
            box["out"], meta["analysis"] = measure(call, device)
        except BaseException as e:
            box["error"] = e
            raise
        return record_of(meta["analysis"])

    try:
        _, hit = cache.get_or_compile(ckey, build, site=site, meta=parts,
                                      xstats_meta=meta)
        if outcome is not None:
            outcome[site] = "hit" if hit else "miss"
    except BaseException:
        if "error" in box:
            raise box["error"]
        # a cache fault outside the dispatch: it still runs, once
    out = box["out"] if "out" in box else call()
    ent = meta.get("entry")
    if ent is not None:
        memo[key] = ent
        note_dispatch(ent)
    return out


def on_step_envelope(env: dict):
    """Step-profiler join hook: called once per recorded envelope."""
    if not enabled():
        return
    try:
        default_exec_registry().on_step_envelope(env)
    except Exception:  # noqa: BLE001 - hot path, never raise
        pass


def on_anomaly(env: dict, trace_id: Optional[str]):
    """Straggler / numerics anomaly hook: maybe trigger the capture."""
    if not enabled():
        return
    try:
        default_profile_ring().trigger_anomaly(trace_id, env)
    except Exception:  # noqa: BLE001
        pass


def execz_payload(compute: bool = True) -> dict:
    return default_exec_registry().execz_payload(compute=compute)


def profilez_payload() -> dict:
    return default_profile_ring().profilez_payload()


def capture_profile(duration_ms: float, *, reason: str = "manual",
                    trace_id: Optional[str] = None):
    return default_profile_ring().capture(duration_ms, reason=reason,
                                          trace_id=trace_id)


def wait_captures(timeout: float = 10.0):
    default_profile_ring().wait_captures(timeout)
