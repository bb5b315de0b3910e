"""Continuous step profiler: an always-on bounded ring of per-step timing
envelopes with straggler detection (the port of
``paddle_tpu/observability/stepprof.py``).

Every decode iteration, prefill group and verify window of the
``GenerationServer`` drops one fixed-size envelope into a bounded ring::

    {step, kind, unix_ms, wall_ms, host_ms?, device_ms?,
     occupancy?, kv_pages_used?, device_peak_bytes?}

``device_peak_bytes`` is ``torch.cuda.max_memory_allocated`` of the
device the caller names (``device=``), read every 64th envelope and
cached between; it is absent for the CPU, as the reference's is where no
device-memory gauge exists.

**Anomaly detection** is EWMA + MAD per step kind: an exponentially
weighted mean of the step's wall time and a bounded window for the
median-absolute-deviation scale; a step slower than
``ewma + k * 1.4826 * MAD`` (``FLAGS_stepprof_anomaly_k``) after
``FLAGS_stepprof_min_samples`` warm-up samples is a straggler. A
straggler is recorded as an error-status span (``stepprof::straggler``)
through the tracing layer, which tail-promotes it into the flight
recorder, so a slow step is a retrievable event in ``/tracez``.

Every envelope goes to ``xstats.on_step_envelope`` (the
``paddle_mfu{kind=}`` join with the step kind's registered cost), and a
straggler to ``xstats.on_anomaly`` (the ``/profilez`` capture armed by
``FLAGS_profile_on_anomaly``).

Deterministic under test: ``now``/``wall_ns`` are injected.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

import torch

from .registry import MetricRegistry, default_registry

__all__ = ["StepProfiler", "default_profiler", "set_default_profiler",
           "record_step"]


def _flag(name, default):
    from ..framework.flags import flag_value
    try:
        return flag_value(name)
    except KeyError:
        return default


class _KindStats:
    """EWMA + MAD detector state for one step kind (train / decode).
    The MAD (a sort of the deviation window) is refreshed every
    ``_MAD_REFRESH`` samples, not per step — the scale estimate moves
    slowly and the hot path stays a deque append."""

    _MAD_REFRESH = 16

    __slots__ = ("ewma", "n", "devs", "anomalies", "hist_child",
                 "_mad", "_mad_age")

    def __init__(self, mad_window: int = 256):
        self.ewma: Optional[float] = None
        self.n = 0
        self.devs: deque = deque(maxlen=mad_window)
        self.anomalies = 0
        self.hist_child = None      # cached histogram label child
        self._mad = 0.0
        self._mad_age = 0

    def mad(self) -> float:
        if self._mad_age >= self._MAD_REFRESH or \
                (self._mad == 0.0 and self.devs):
            vals = sorted(self.devs)
            self._mad = vals[len(vals) // 2] if vals else 0.0
            self._mad_age = 0
        return self._mad


class StepProfiler:
    """Bounded envelope ring + per-kind straggler detector."""

    def __init__(self, window: Optional[int] = None,
                 alpha: float = 0.1,
                 anomaly_k: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 registry: Optional[MetricRegistry] = None,
                 now: Callable[[], float] = time.monotonic,
                 wall_ns: Callable[[], int] = time.time_ns):
        self._window = int(window if window is not None
                           else _flag("FLAGS_stepprof_window", 512))
        self._alpha = float(alpha)
        self._k = float(anomaly_k if anomaly_k is not None
                        else _flag("FLAGS_stepprof_anomaly_k", 6.0))
        self._min = int(min_samples if min_samples is not None
                        else _flag("FLAGS_stepprof_min_samples", 32))
        self._now = now
        self._wall_ns = wall_ns
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self._window)
        self._kinds: Dict[str, _KindStats] = {}
        self._total = 0
        reg = registry or default_registry()
        self._c_anomalies = reg.counter(
            "paddle_step_anomalies_total",
            "steps flagged as stragglers by the EWMA+MAD detector",
            ("kind",))
        self._h_wall = reg.histogram(
            "paddle_step_wall_ms",
            "per-step wall time from the continuous step profiler",
            ("kind",))

    # ------------------------------------------------------- recording
    def record_step(self, wall_ms: float, *, kind: str = "train",
                    step: Optional[int] = None,
                    host_ms: Optional[float] = None,
                    device_ms: Optional[float] = None,
                    occupancy: Optional[int] = None,
                    kv_pages_used: Optional[int] = None,
                    attrs: Optional[dict] = None,
                    device=None) -> dict:
        """Drop one envelope; runs the detector; returns the envelope
        (with ``anomaly`` set when flagged). ``device`` names the device
        whose peak memory the envelope carries (none for the CPU)."""
        wall_ms = float(wall_ms)
        env = {"kind": kind, "unix_ms": self._wall_ns() // 1_000_000,
               "wall_ms": round(wall_ms, 4)}
        if step is not None:
            env["step"] = int(step)
        if host_ms is not None:
            env["host_ms"] = round(float(host_ms), 4)
        if device_ms is not None:
            env["device_ms"] = round(float(device_ms), 4)
        if occupancy is not None:
            env["occupancy"] = int(occupancy)
        if kv_pages_used is not None:
            env["kv_pages_used"] = int(kv_pages_used)
        peak = self._device_peak_bytes(device)
        if peak is not None:
            env["device_peak_bytes"] = peak
        if attrs:
            env.update(attrs)
        anomaly = None
        with self._lock:
            st = self._kinds.get(kind)
            if st is None:
                st = self._kinds[kind] = _KindStats()
            if st.ewma is not None and st.n >= self._min:
                scale = 1.4826 * st.mad()
                threshold = st.ewma + self._k * max(scale, 1e-9)
                if wall_ms > threshold:
                    anomaly = {"ewma_ms": round(st.ewma, 4),
                               "mad_ms": round(st.mad(), 4),
                               "threshold_ms": round(threshold, 4)}
                    st.anomalies += 1
            if st.ewma is None:
                st.ewma = wall_ms
            elif anomaly is None:
                # anomalous samples do not drag the baseline: a burst
                # of stragglers stays anomalous instead of becoming
                # the new normal
                st.ewma += self._alpha * (wall_ms - st.ewma)
            if anomaly is None:
                st.devs.append(abs(wall_ms - st.ewma))
                st._mad_age += 1
            st.n += 1
            if anomaly is not None:
                env["anomaly"] = anomaly
            self._ring.append(env)
            self._total += 1
            child = st.hist_child
            if child is None:
                child = st.hist_child = self._h_wall.labels(kind=kind)
        child.observe(wall_ms)
        try:
            # xstats join: the envelope's kind meets the live entry's
            # cost numbers (paddle_mfu{kind=} and the bandwidth gauge;
            # dict lookups and gauge sets, nothing is measured here)
            from . import xstats
            xstats.on_step_envelope(env)
        except Exception:  # noqa: BLE001 - garnish on the hot path
            pass
        if anomaly is not None:
            self._c_anomalies.labels(kind=kind).inc()
            trace_id = self._emit_anomaly_span(env, anomaly)
            try:
                # armed by FLAGS_profile_on_anomaly: one rate-limited
                # background capture linked to the straggler's trace
                from . import xstats
                xstats.on_anomaly(env, trace_id)
            except Exception:  # noqa: BLE001 - never break a step
                pass
        return env

    _PEAK_PROBE_EVERY = 64

    def _device_peak_bytes(self, device) -> Optional[int]:
        """Cheap watermark: ``torch.cuda.max_memory_allocated`` of a CUDA
        ``device``, None for the CPU or no device. The read is amortized:
        the cached value is refreshed every ``_PEAK_PROBE_EVERY``
        envelopes (the watermark is a scrape-cadence signal, not a
        per-step one)."""
        if device is None or torch.device(device).type != "cuda":
            return None
        age = getattr(self, "_peak_age", None)
        if age is not None and age < self._PEAK_PROBE_EVERY:
            self._peak_age = age + 1
            return self._peak_cache
        self._peak_age = 1
        self._peak_cache = None
        try:
            self._peak_cache = int(torch.cuda.max_memory_allocated(device))
        except Exception:  # noqa: BLE001 - the envelope must never fail
            pass
        return self._peak_cache

    def _emit_anomaly_span(self, env: dict, anomaly: dict):
        """A straggler becomes a traceable event: an error-status span
        recorded under a fresh sampled context rides the tail-promotion
        path into the flight recorder. Returns the span's trace id."""
        try:
            from . import tracing
            ctx = tracing.new_context(sampled=True)
            attrs = {"kind": env["kind"],
                     "wall_ms": env["wall_ms"],
                     "error": "step straggler: "
                              f"{env['wall_ms']}ms vs threshold "
                              f"{anomaly['threshold_ms']}ms"}
            attrs.update(anomaly)
            if "step" in env:
                attrs["step"] = env["step"]
            tracing.record_span(
                ctx, "stepprof::straggler", stage="anomaly",
                start_unix_ns=env["unix_ms"] * 1_000_000
                - int(env["wall_ms"] * 1e6),
                duration_ms=env["wall_ms"], status="error",
                attrs=attrs, root=True)
            return ctx.trace_id
        except Exception:  # noqa: BLE001 - detection is garnish on the
            return None    # hot path; never let it break a step

    # ------------------------------------------------------- views
    def envelopes(self, kind: Optional[str] = None, limit: int = 100
                  ) -> list:
        with self._lock:
            envs = list(self._ring)
        if kind is not None:
            envs = [e for e in envs if e["kind"] == kind]
        return envs[-int(limit):]

    def summary(self) -> dict:
        """Per-kind live stats: EWMA, MAD, sample and
        anomaly counts, plus the most recent anomalous envelopes."""
        with self._lock:
            kinds = {
                k: {"ewma_ms": round(st.ewma, 4)
                    if st.ewma is not None else None,
                    "mad_ms": round(st.mad(), 4),
                    "samples": st.n,
                    "anomalies": st.anomalies}
                for k, st in self._kinds.items()}
            recent_anomalies = [e for e in self._ring if "anomaly" in e]
            n_ring = len(self._ring)
            total = self._total
        return {"window": self._window, "ring": n_ring,
                "total_steps": total, "kinds": kinds,
                "recent_anomalies": recent_anomalies[-20:]}

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._kinds.clear()
            self._total = 0


_default_lock = threading.Lock()
_default: Optional[StepProfiler] = None


def default_profiler() -> StepProfiler:
    """The process-wide profiler every step recorder reports into."""
    global _default
    with _default_lock:
        if _default is None:
            _default = StepProfiler()
        return _default


def set_default_profiler(prof: Optional[StepProfiler]
                         ) -> Optional[StepProfiler]:
    """Swap the process-wide profiler (tests; ``None`` resets to a
    fresh one on next use). Returns the previous profiler."""
    global _default
    with _default_lock:
        prev, _default = _default, prof
    return prev


def record_step(wall_ms: float, **kw) -> dict:
    """Module-level convenience onto the default profiler."""
    return default_profiler().record_step(wall_ms, **kw)
