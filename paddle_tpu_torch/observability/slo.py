"""Declarative latency SLOs with multi-window multi-burn-rate alerts (the
port of ``paddle_tpu/observability/slo.py``).

The SRE Workbook (Beyer et al., 2018, ch. 5) shape: an SLO is "P
(target_fraction) of requests complete under T (threshold_ms)", the error
budget is ``1 - target_fraction``, and alerting is on *burn rate*, the
ratio of the observed bad fraction to the budget, over paired short/long
windows (fast burn: 5m + 1h above 14.4x; slow burn: 6h + 3d above 1x).

Samples are not double-recorded: the monitor reads the existing latency
histograms (``paddle_serving_latency_ms``, ``paddle_decode_inter_token_ms``,
any registry histogram) by snapshotting cumulative bucket counts at each
``evaluate()`` and differencing snapshots across rolling windows. Good =
samples at or under the largest bucket bound <= threshold (declare
thresholds on bucket bounds for exact accounting; the effective bound is
reported). Warmup traffic never reaches those histograms, so SLO windows
exclude it; the direct-feed ``observe()`` path takes an explicit
``warmup=`` flag and drops (and counts) excluded samples.

Surfaces: the ``paddle_slo_burn_rate{slo,window}`` and
``paddle_slo_budget_remaining{slo}`` gauges; ``/sloz`` on the telemetry
endpoint (``merge_sloz_payloads`` sums window counts across processes);
alert sinks, callables receiving every alert transition (fire/resolve)
with the burn numbers and an exemplar trace id.

The clock is injected; every window is deterministic under test.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .registry import MetricRegistry, default_registry

__all__ = [
    "BurnRule", "LatencySLO", "SLOMonitor",
    "default_monitor", "set_default_monitor", "latency_slo",
    "add_alert_sink", "remove_alert_sink", "sloz_payload",
    "DEFAULT_BURN_RULES", "merge_sloz_payloads",
]


class BurnRule:
    """One multi-window burn-rate alert rule: fires when the burn rate
    exceeds ``factor`` over BOTH the short and the long window (the
    short window gives fast detection+reset, the long one suppresses
    flapping on blips)."""

    __slots__ = ("name", "short_s", "long_s", "factor", "severity")

    def __init__(self, name: str, short_s: float, long_s: float,
                 factor: float, severity: str = "page"):
        self.name = name
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.factor = float(factor)
        self.severity = severity

    def to_dict(self) -> dict:
        return {"name": self.name, "short_s": self.short_s,
                "long_s": self.long_s, "factor": self.factor,
                "severity": self.severity}


# The SRE Workbook's recommended pairs (ch. 5, "6: Multiwindow,
# Multi-Burn-Rate Alerts"): 14.4x over 5m/1h pages, 1x over 6h/3d
# tickets.
DEFAULT_BURN_RULES = (
    BurnRule("fast_burn", 300.0, 3600.0, 14.4, severity="page"),
    BurnRule("slow_burn", 6 * 3600.0, 3 * 86400.0, 1.0,
             severity="ticket"),
)


class LatencySLO:
    """Declarative latency objective over one registry histogram.

    ``labels`` filters the family's children (subset match:
    ``{"server": "default"}`` selects that server's slice; empty =
    every child summed). ``windows`` are the rolling spans evaluated
    and exported; they default to the union of the burn rules'
    windows."""

    def __init__(self, name: str, metric: str, threshold_ms: float,
                 target_fraction: float,
                 labels: Optional[dict] = None,
                 windows: Optional[Sequence[float]] = None,
                 burn_rules: Optional[Sequence[BurnRule]] = None):
        if not 0.0 < float(target_fraction) < 1.0:
            raise ValueError(
                "target_fraction must be in (0, 1) — an SLO of 1.0 "
                "has no error budget to burn")
        self.name = str(name)
        self.metric = str(metric)
        self.threshold_ms = float(threshold_ms)
        self.target_fraction = float(target_fraction)
        self.labels = dict(labels or {})
        self.burn_rules = tuple(burn_rules if burn_rules is not None
                                else DEFAULT_BURN_RULES)
        if windows is None:
            windows = sorted({w for r in self.burn_rules
                              for w in (r.short_s, r.long_s)})
        self.windows = tuple(float(w) for w in windows)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target_fraction

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "threshold_ms": self.threshold_ms,
                "target_fraction": self.target_fraction,
                "labels": dict(self.labels),
                "windows_s": list(self.windows),
                "burn_rules": [r.to_dict() for r in self.burn_rules]}


class _SLOState:
    """Monitor-side state for one SLO: the snapshot ring of
    ``(t, good, total)`` cumulative counts and per-rule firing
    state."""

    __slots__ = ("slo", "snaps", "firing", "effective_bound",
                 "direct_good", "direct_total")

    def __init__(self, slo: LatencySLO, maxlen: int):
        self.slo = slo
        self.snaps: deque = deque(maxlen=maxlen)
        self.firing: Dict[str, bool] = {r.name: False
                                        for r in slo.burn_rules}
        self.effective_bound: Optional[float] = None
        self.direct_good = 0     # direct-feed path (no histogram)
        self.direct_total = 0


class SLOMonitor:
    """Evaluates registered SLOs over deterministic rolling windows
    and drives the alert sinks + gauges."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 now: Callable[[], float] = time.monotonic,
                 max_snapshots: int = 4096):
        self._reg = registry or default_registry()
        self._now = now
        self._lock = threading.Lock()
        self._states: "Dict[str, _SLOState]" = {}
        self._sinks: Dict[str, Callable] = {}
        self._max_snapshots = int(max_snapshots)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._g_burn = self._reg.gauge(
            "paddle_slo_burn_rate",
            "error-budget burn rate per SLO and rolling window "
            "(1.0 = burning exactly the budget)", ("slo", "window"))
        self._g_budget = self._reg.gauge(
            "paddle_slo_budget_remaining",
            "fraction of the error budget left over the longest "
            "configured window (negative = overspent)", ("slo",))
        self._c_excluded = self._reg.counter(
            "paddle_slo_samples_excluded_total",
            "direct-feed samples dropped from SLO windows because "
            "they were warmup/readiness traffic", ("slo",))

    # ------------------------------------------------------- registry
    def add(self, slo: LatencySLO) -> LatencySLO:
        with self._lock:
            if slo.name in self._states:
                raise ValueError(f"SLO {slo.name!r} already declared")
            self._states[slo.name] = _SLOState(slo,
                                               self._max_snapshots)
        return slo

    def remove(self, name: str):
        with self._lock:
            self._states.pop(name, None)
        self._g_burn.clear(slo=name)
        self._g_budget.clear(slo=name)

    def slos(self) -> List[LatencySLO]:
        with self._lock:
            return [s.slo for s in self._states.values()]

    def clear(self):
        with self._lock:
            names = list(self._states)
            self._states.clear()
        for n in names:
            self._g_burn.clear(slo=n)
            self._g_budget.clear(slo=n)

    # ------------------------------------------------------- sinks
    def add_alert_sink(self, name: str, fn: Callable):
        """Register ``fn(alert: dict)``; called on every firing
        transition (``alert["firing"]`` True on fire, False on
        resolve). A raising sink is isolated, never fatal."""
        with self._lock:
            self._sinks[name] = fn

    def remove_alert_sink(self, name: str):
        with self._lock:
            self._sinks.pop(name, None)

    # ------------------------------------------------------- sampling
    def observe(self, name: str, latency_ms: float,
                warmup: bool = False):
        """Direct-feed path for SLOs without a backing histogram:
        count one sample against the threshold. Warmup/readiness
        samples are dropped (and counted) — the same exclusion the
        histogram path inherits from ``record_traffic=False``."""
        with self._lock:
            st = self._states.get(name)
        if st is None:
            raise KeyError(f"unknown SLO {name!r}")
        if warmup:
            self._c_excluded.labels(slo=name).inc()
            return
        with self._lock:
            st.direct_total += 1
            if float(latency_ms) <= st.slo.threshold_ms:
                st.direct_good += 1

    def _histogram_counts(self, st: _SLOState
                          ) -> Optional[Tuple[int, int]]:
        """(good, total) cumulative counts from the SLO's histogram
        family, summed over label-matching children; None when the
        family does not exist (yet)."""
        fam = self._reg.get(st.slo.metric)
        if fam is None or fam.kind != "histogram":
            return None
        good = total = 0
        matched = False
        for labels, child in fam.collect():
            if any(labels.get(k) != str(v)
                   for k, v in st.slo.labels.items()):
                continue
            matched = True
            bound_le = None
            for ub, cum in child.buckets():
                if ub <= st.slo.threshold_ms:
                    bound_le = ub
                    good_here = cum
                else:
                    break
            if bound_le is not None:
                st.effective_bound = bound_le
                good += good_here
            total += child.count
        if not matched:
            return (0, 0)
        return (good, total)

    def _snapshot(self, st: _SLOState, t: float):
        counts = self._histogram_counts(st)
        with self._lock:
            dg, dt = st.direct_good, st.direct_total
        if counts is None:
            good, total = dg, dt
        else:
            good, total = counts[0] + dg, counts[1] + dt
        st.snaps.append((t, good, total))

    @staticmethod
    def _window_delta(snaps, t: float, window_s: float) -> dict:
        """Counts over ``[t - window_s, t]`` by differencing the
        newest snapshot against the latest one at or before the window
        start (partial coverage uses the oldest snapshot and says
        so)."""
        if not snaps:
            return {"good": 0, "total": 0, "bad_fraction": 0.0,
                    "covered": False}
        t_now, good_now, total_now = snaps[-1]
        base = None
        for s in snaps:
            if s[0] <= t - window_s:
                base = s
            else:
                break
        covered = base is not None
        if base is None:
            base = snaps[0]
        d_total = max(0, total_now - base[2])
        d_good = max(0, good_now - base[1])
        bad = (d_total - d_good) / d_total if d_total > 0 else 0.0
        return {"good": d_good, "total": d_total,
                "bad_fraction": bad, "covered": covered}

    # ------------------------------------------------------- evaluate
    def evaluate(self, t: Optional[float] = None) -> dict:
        """One evaluation pass: snapshot every SLO's counts, compute
        window deltas + burn rates, update gauges, run the alert
        rules, notify sinks on transitions. Returns the ``/sloz``
        payload."""
        t = self._now() if t is None else float(t)
        with self._lock:
            states = list(self._states.values())
            sinks = list(self._sinks.items())
        out = []
        transitions = []
        for st in states:
            self._snapshot(st, t)
            slo = st.slo
            windows = {}
            for w in slo.windows:
                d = self._window_delta(st.snaps, t, w)
                d["burn_rate"] = round(
                    d["bad_fraction"] / slo.error_budget, 4)
                windows[self._wlabel(w)] = d
                self._g_burn.labels(slo=slo.name,
                                    window=self._wlabel(w)).set(
                    d["burn_rate"])
            longest = self._wlabel(max(slo.windows))
            budget_remaining = round(
                1.0 - windows[longest]["burn_rate"], 4)
            self._g_budget.labels(slo=slo.name).set(budget_remaining)
            alerts = []
            for rule in slo.burn_rules:
                short = windows.get(self._wlabel(rule.short_s)) or \
                    self._window_delta(st.snaps, t, rule.short_s)
                long = windows.get(self._wlabel(rule.long_s)) or \
                    self._window_delta(st.snaps, t, rule.long_s)
                b_short = short["bad_fraction"] / slo.error_budget
                b_long = long["bad_fraction"] / slo.error_budget
                firing = b_short > rule.factor and \
                    b_long > rule.factor
                alert = {
                    "slo": slo.name, "rule": rule.name,
                    "severity": rule.severity,
                    "firing": firing,
                    "factor": rule.factor,
                    "burn_short": round(b_short, 4),
                    "burn_long": round(b_long, 4),
                    "short_s": rule.short_s, "long_s": rule.long_s,
                    "threshold_ms": slo.threshold_ms,
                    "target_fraction": slo.target_fraction,
                    "exemplar_trace_id": self._exemplar(slo),
                }
                alerts.append(alert)
                if firing != st.firing[rule.name]:
                    st.firing[rule.name] = firing
                    transitions.append(alert)
            out.append({
                "slo": slo.to_dict(),
                "effective_threshold_ms": st.effective_bound,
                "windows": windows,
                "budget_remaining": budget_remaining,
                "alerts": alerts,
                "firing": [a["rule"] for a in alerts if a["firing"]],
            })
        for alert in transitions:
            for _, fn in sinks:
                try:
                    fn(dict(alert))
                except Exception:  # noqa: BLE001 - a broken sink must
                    pass           # not stop evaluation or its peers
        return {"t": t, "slos": out}

    @staticmethod
    def _wlabel(w: float) -> str:
        w = float(w)
        if w >= 86400 and w % 86400 == 0:
            return f"{int(w // 86400)}d"
        if w >= 3600 and w % 3600 == 0:
            return f"{int(w // 3600)}h"
        if w >= 60 and w % 60 == 0:
            return f"{int(w // 60)}m"
        return f"{w:g}s"

    def _exemplar(self, slo: LatencySLO) -> Optional[str]:
        """The exemplar link: the latest trace id seen in the
        worst bucket above the threshold (the request an operator
        should look at), else the slowest recorded one."""
        try:
            from . import tracing
            table = tracing.exemplars(slo.metric)
        except Exception:  # noqa: BLE001
            return None
        if not table:
            return None
        over = [(e["value_ms"], e["trace_id"])
                for e in table.values()
                if e["value_ms"] > slo.threshold_ms]
        pool = over or [(e["value_ms"], e["trace_id"])
                        for e in table.values()]
        return max(pool)[1] if pool else None

    # ------------------------------------------------------- evaluator
    def start(self, interval_s: Optional[float] = None
              ) -> "SLOMonitor":
        """Periodic evaluation on a daemon thread
        (``FLAGS_slo_eval_interval_s`` default)."""
        if interval_s is None:
            try:
                from ..framework.flags import flag_value
                interval_s = float(
                    flag_value("FLAGS_slo_eval_interval_s"))
            except Exception:  # noqa: BLE001
                interval_s = 10.0
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="slo-evaluator", daemon=True)
            self._thread.start()
        return self

    def _loop(self, interval_s: float):
        while not self._stop.wait(interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 - the evaluator must
                pass           # survive any single bad pass

    def stop(self):
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5)

    # ------------------------------------------------------- payload
    def sloz_payload(self, evaluate: bool = True) -> dict:
        """The ``/sloz`` JSON document (evaluates by default so a
        scrape is always current)."""
        from .tracing import process_name
        doc = self.evaluate() if evaluate else {"t": self._now(),
                                                "slos": []}
        doc["process"] = process_name()
        return doc


def merge_sloz_payloads(own: dict, remotes: Dict[str, dict]) -> dict:
    """Fleet aggregation: sum window good/total counts across
    processes per (slo name, window label) and recompute bad
    fraction + burn rate — the router's ``/sloz`` view, shaped like
    the per-process document plus per-replica sub-documents."""
    merged: Dict[str, dict] = {}
    for entry in own.get("slos", []):
        merged[entry["slo"]["name"]] = _copy_entry(entry)
    for rid, doc in sorted(remotes.items()):
        for entry in doc.get("slos", []):
            name = entry["slo"]["name"]
            if name not in merged:
                merged[name] = _copy_entry(entry)
                continue
            tgt = merged[name]
            budget = 1.0 - tgt["slo"]["target_fraction"]
            for wl, d in entry.get("windows", {}).items():
                td = tgt["windows"].setdefault(
                    wl, {"good": 0, "total": 0, "bad_fraction": 0.0,
                         "covered": d.get("covered", False),
                         "burn_rate": 0.0})
                td["good"] += d.get("good", 0)
                td["total"] += d.get("total", 0)
                total = td["total"]
                bad = (total - td["good"]) / total if total else 0.0
                td["bad_fraction"] = round(bad, 6)
                td["burn_rate"] = round(bad / budget, 4)
                td["covered"] = td["covered"] and d.get("covered",
                                                        False)
    return {"process": own.get("process"),
            "replicas": sorted(remotes),
            "slos": list(merged.values())}


def _copy_entry(entry: dict) -> dict:
    out = dict(entry)
    out["windows"] = {k: dict(v)
                      for k, v in entry.get("windows", {}).items()}
    return out


# ------------------------------------------------------------- default
_default_lock = threading.Lock()
_default: Optional[SLOMonitor] = None


def default_monitor() -> SLOMonitor:
    """The process-wide monitor ``/sloz`` serves."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SLOMonitor()
        return _default


def set_default_monitor(mon: Optional[SLOMonitor]
                        ) -> Optional[SLOMonitor]:
    """Swap the process-wide monitor (tests; ``None`` resets to a
    fresh one on next use). Returns the previous monitor."""
    global _default
    with _default_lock:
        prev, _default = _default, mon
    return prev


def latency_slo(name: str, threshold_ms: float,
                target_fraction: float, *,
                metric: str = "paddle_serving_latency_ms",
                labels: Optional[dict] = None,
                windows: Optional[Sequence[float]] = None,
                burn_rules: Optional[Sequence[BurnRule]] = None
                ) -> LatencySLO:
    """Declare a latency SLO on the default monitor::

        latency_slo("serving_p99", threshold_ms=100.0,
                    target_fraction=0.99)
    """
    slo = LatencySLO(name, metric, threshold_ms, target_fraction,
                     labels=labels, windows=windows,
                     burn_rules=burn_rules)
    return default_monitor().add(slo)


def add_alert_sink(name: str, fn: Callable):
    default_monitor().add_alert_sink(name, fn)


def remove_alert_sink(name: str):
    default_monitor().remove_alert_sink(name)


def sloz_payload() -> dict:
    return default_monitor().sloz_payload()
