"""Numerics and silent-data-corruption observability (the port of
``paddle_tpu/observability/numerics.py``): this layer watches correctness,
where the rest of the package watches performance. The dominant
wrong-answer sources it covers are the hand-written kernels, int8 KV
quantization and per-device silent data corruption:

- **NaN/Inf tripwires**: fixed-shape reductions on the device over
  ``TrainStep``'s gradients and the ``CachedDecoder``'s logits (finite
  fraction, max-abs, argmax entropy, grad norm and its EWMA drift, loss
  scale). No note syncs the step: a note copies its stats into pinned host
  memory with ``non_blocking=True`` and records a CUDA event after the
  copy; the values are published at the next note (or at ``drain()``), by
  when the event has long completed. ``FLAGS_check_nan_inf`` arms every
  step; ``FLAGS_numerics_sample_rate`` gives a sampled regime.
- **Sampled shadow checks**: a decode, chunked or verify dispatch runs
  first through the kernels' plain versions (``use_kernels=False``) on a
  compact copy of the pages its block tables name
  (``CachedDecoder._shadow``), and the max-abs logit divergence from the
  kernel route is published as ``paddle_numerics_shadow_divergence{kind,
  dtype}`` (a gauge plus payload percentiles).
- **Device canary sweeps**: a deterministic uint32 LCG+xorshift checksum
  with a bit-exact numpy golden twin (``canary_reference``), run per
  worker every ``FLAGS_numerics_canary_period_s`` and on readiness
  transitions. The device computes the uint32 rounds in int64 masked to 32
  bits (torch's uint32 arithmetic on CUDA is incomplete); the result must
  equal the twin exactly. A mismatch is silent data corruption: the
  replica quarantines itself (``fleet.worker.arm_canary``).

Anomalies (non-finite outputs, non-finite shadow divergences, canary
failures) are emitted as tail-promoted error spans into the trace flight
recorder and handed to ``xstats.on_anomaly`` (the arm-gated, rate-limited
path that starts exactly one background ``/profilez`` capture per
burst). Every note swallows its own exceptions; with the three knobs at
their 0 defaults every hook is a cheap no-op.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "SHADOW_SITES", "CanaryRunner",
    "enabled", "tripwire_rate", "shadow_rate", "train_tripwire_armed",
    "sample_decision", "set_rng_for_tests", "reset_for_tests", "drain",
    "note_serving_logits", "note_train_step", "note_shadow_divergence",
    "note_int8_scales", "logit_stats", "grad_stats",
    "canary_reference", "canary_sweep", "run_device_canary",
    "numericsz_payload",
]

# dispatch sites eligible for shadow checks (prefill is excluded: its cost
# dwarfs a decode step and the chunked path covers the same kernel)
SHADOW_SITES = ("generate_decode", "generate_chunked", "generate_verify")

_EWMA_ALPHA = 0.1        # grad-norm drift smoothing
_PENDING_MAX = 64        # deferred-publication queue bound
_SHADOW_WINDOW = 512     # divergence percentile window per (kind, dtype)

_CANARY_N = 4096
_CANARY_ROUNDS = 4
_CANARY_MASK = (1 << 32) - 1


# ----------------------------------------------------------- knobs
def _flag(name: str, default):
    try:
        from ..framework.flags import flag_value
        return flag_value(name)
    except KeyError:
        return default


def tripwire_rate() -> float:
    """Effective tripwire duty cycle: ``FLAGS_check_nan_inf`` arms every
    step, otherwise ``FLAGS_numerics_sample_rate``."""
    if bool(_flag("FLAGS_check_nan_inf", False)):
        return 1.0
    try:
        rate = float(_flag("FLAGS_numerics_sample_rate", 0.0))
    except (TypeError, ValueError):
        return 0.0
    return max(0.0, min(1.0, rate))


def shadow_rate() -> float:
    try:
        rate = float(_flag("FLAGS_numerics_shadow_rate", 0.0))
    except (TypeError, ValueError):
        return 0.0
    return max(0.0, min(1.0, rate))


def enabled() -> bool:
    return tripwire_rate() > 0.0 or shadow_rate() > 0.0


def train_tripwire_armed() -> bool:
    """Whether a ``TrainStep`` computes the grad-health reductions; pinned
    at its construction, as the reference pins it."""
    return tripwire_rate() > 0.0


# ------------------------------------------------------------- rng
_RNG_LOCK = threading.Lock()
_rng = None


def set_rng_for_tests(rng) -> None:
    """Swap the sampling RNG (a seeded ``random.Random`` makes duty-cycle
    decisions reproducible); None restores the default."""
    global _rng
    with _RNG_LOCK:
        _rng = rng


def sample_decision(rate: float) -> bool:
    """One Bernoulli draw against ``rate`` from the module RNG."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    global _rng
    with _RNG_LOCK:
        if _rng is None:
            import random
            _rng = random.Random(0x9E3779B9)
        return _rng.random() < rate


# --------------------------------------------------------- metrics
_METRICS_LOCK = threading.Lock()
_metrics = None


class _Metrics:
    """Lazy singleton over the default registry (families are
    get-or-create, so re-instantiation is idempotent)."""

    def __init__(self):
        from .registry import default_registry
        reg = default_registry()
        self.checks = reg.counter(
            "paddle_numerics_checks_total",
            "tripwire health checks published, by dispatch kind",
            ("kind",))
        self.anomalies = reg.counter(
            "paddle_numerics_anomalies_total",
            "numerics anomalies (non-finite outputs, shadow blow-ups, "
            "canary failures) by kind and reason", ("kind", "reason"))
        self.shadow_checks = reg.counter(
            "paddle_numerics_shadow_checks_total",
            "sampled shadow runs through the kernels' plain versions",
            ("kind", "dtype"))
        self.canary_runs = reg.counter(
            "paddle_numerics_canary_runs_total",
            "device canary sweeps run")
        self.canary_failures = reg.counter(
            "paddle_numerics_canary_failures_total",
            "device canary sweeps whose checksum mismatched (SDC)")
        self.finite_fraction = reg.gauge(
            "paddle_numerics_finite_fraction",
            "fraction of finite values in the last checked output",
            ("kind",))
        self.max_abs = reg.gauge(
            "paddle_numerics_logit_max_abs",
            "max |logit| of the last checked output (finite values "
            "only)", ("kind",))
        self.argmax_entropy = reg.gauge(
            "paddle_numerics_argmax_entropy",
            "entropy of the batch argmax-id distribution: a collapse to 0 "
            "on a busy batch means every lane argmaxes the same token",
            ("kind",))
        self.grad_norm = reg.gauge(
            "paddle_numerics_grad_norm",
            "global grad norm of the last checked train step")
        self.grad_norm_drift = reg.gauge(
            "paddle_numerics_grad_norm_drift",
            "relative deviation of the last grad norm from its EWMA")
        self.loss_scale = reg.gauge(
            "paddle_numerics_loss_scale",
            "live dynamic loss scale of the AMP step")
        self.shadow_divergence = reg.gauge(
            "paddle_numerics_shadow_divergence",
            "max-abs logit divergence of the last shadow-checked dispatch "
            "from the kernels' plain versions (unitless logit delta: a "
            "gauge plus payload percentiles, not a histogram)",
            ("kind", "dtype"))
        self.int8_scale_drift = reg.gauge(
            "paddle_numerics_int8_scale_drift",
            "relative drift of the int8 KV absmax-scale magnitude vs its "
            "first-seen baseline", ("kind",))
        self.canary_ok = reg.gauge(
            "paddle_numerics_canary_ok",
            "1 while the latest canary sweep matched its golden checksum, "
            "0 after a mismatch")


def _get_metrics() -> _Metrics:
    global _metrics
    with _METRICS_LOCK:
        if _metrics is None:
            _metrics = _Metrics()
        return _metrics


# ------------------------------------------------- device reductions
def logit_stats(logits: torch.Tensor) -> torch.Tensor:
    """``[finite_fraction, max_abs, argmax_entropy]`` (float32, on the
    logits' device) of a logits tensor ``[B, vocab]`` or ``[B, S,
    vocab]``: the reference's ``_logit_stats_fn``."""
    x = logits.detach().float()
    finite = torch.isfinite(x)
    frac = finite.float().mean()
    safe = torch.where(finite, x, torch.zeros((), device=x.device))
    max_abs = safe.abs().max()
    flat = safe.reshape(-1, safe.shape[-1])
    am = flat.argmax(-1)
    # index_add_, not bincount: bincount on CUDA reads its input's max
    # back to the host (a sync)
    counts = torch.zeros(safe.shape[-1], dtype=torch.float32,
                         device=x.device).index_add_(
        0, am, torch.ones(am.shape, dtype=torch.float32, device=x.device))
    p = counts / counts.sum().clamp(min=1.0)
    ent = -torch.where(p > 0, p * torch.log(p),
                       torch.zeros((), device=x.device)).sum()
    return torch.stack([frac, max_abs, ent])


def grad_stats(grads, loss: torch.Tensor) -> torch.Tensor:
    """``[grad_norm, grad_finite_fraction, loss_is_finite]`` (float32, on
    the device) over a list of gradients: the reference's in-graph
    reductions (the norm over the finite elements, in float32). Each
    gradient is read three times: the finite mask, the masked copy, its
    float32 norm (``vector_norm(dtype=)`` makes no float32 copy)."""
    total = float(sum(g.numel() for g in grads) or 1)
    sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    finite_ct = torch.zeros((), dtype=torch.float32, device=loss.device)
    for g in grads:
        fin = torch.isfinite(g)
        finite_ct = finite_ct + fin.sum(dtype=torch.float32)
        masked = torch.where(fin, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
        sq = sq + torch.linalg.vector_norm(masked,
                                           dtype=torch.float32).square()
    return torch.stack([sq.sqrt(), finite_ct / total,
                        torch.isfinite(loss.detach()).float().reshape(())])


def _scale_summary(leaves) -> torch.Tensor:
    """Mean over ``leaves`` of each one's mean |value| (float32)."""
    acc = None
    for x in leaves:
        m = x.detach().float().abs().mean()
        acc = m if acc is None else acc + m
    return acc / float(len(leaves))


# ------------------------------------------------------------ canary
_canary_ref_memo = None
_CANARY_LOCK = threading.Lock()


def canary_reference() -> int:
    """Host golden twin of the device canary: the uint32 LCG+xorshift
    rounds in numpy (integer arrays wrap modularly), the wrapping sum as a
    uint64 sum mod 2^32."""
    global _canary_ref_memo
    with _CANARY_LOCK:
        if _canary_ref_memo is None:
            x = np.arange(_CANARY_N, dtype=np.uint32)
            for _ in range(_CANARY_ROUNDS):
                x = x * np.uint32(1664525) + np.uint32(1013904223)
                x = x ^ (x >> np.uint32(16))
            _canary_ref_memo = int(x.astype(np.uint64).sum()) & _CANARY_MASK
        return _canary_ref_memo


def canary_sweep(device) -> torch.Tensor:
    """The canary's rounds on ``device``: uint32 arithmetic computed in
    int64 masked to 32 bits (a product of a 32-bit value and the 21-bit
    multiplier stays below 2^53), the wrapping sum masked likewise.
    Returns a 0-d int64 tensor on the device."""
    mask = _CANARY_MASK
    x = torch.arange(_CANARY_N, dtype=torch.int64, device=device)
    for _ in range(_CANARY_ROUNDS):
        x = (x * 1664525 + 1013904223) & mask
        x = x ^ (x >> 16)
    return x.sum() & mask


# ----------------------------------------------------- state store
def _stage(t: torch.Tensor):
    """``(host values, event)``: a CUDA tensor is copied into pinned host
    memory without blocking, with an event recorded after the copy; a CPU
    tensor is its own host copy (event None)."""
    t = t.detach()
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _ready(entry: dict) -> bool:
    ev = entry.get("event")
    return ev is None or ev.query()


def _values(entry: dict):
    ev = entry.get("event")
    if ev is not None:
        ev.synchronize()
    return entry["stats"]


class _State:
    """All host-side numerics bookkeeping behind one lock. Staged stats
    wait in ``_pending`` until the NEXT note (or a drain) publishes them;
    an entry whose copy has not completed yet waits for a later note, so a
    note never stalls on the step that produced it (past ``_PENDING_MAX``
    waiting entries the oldest is waited for)."""

    def __init__(self):
        from .registry import PercentileWindow
        self._window_cls = PercentileWindow
        self._lock = threading.Lock()
        self._pending = collections.deque()
        self._serving: Dict[str, dict] = {}
        self._train = {"steps": 0, "grad_norm": None,
                       "grad_norm_ewma": None, "grad_norm_drift": None,
                       "grad_finite_fraction": None, "loss_finite": None,
                       "loss_scale": None}
        self._shadow: Dict[Tuple[str, str], dict] = {}
        self._int8: Dict[str, dict] = {}
        self._canary = {"runs": 0, "failures": 0, "ok": None,
                        "corrupt": False, "last": None}
        self._anomalies = {"total": 0, "by_reason": {}, "last": None}

    # -- deferred-publication queue
    def push(self, entry: dict):
        with self._lock:
            self._pending.append(entry)
            out = []
            while len(self._pending) > 1 and (
                    len(self._pending) > _PENDING_MAX
                    or _ready(self._pending[0])):
                out.append(self._pending.popleft())
            return out

    def pop_all(self):
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
            return out

    # -- per-domain updates (values are host floats here)
    def serving_update(self, kind, frac, max_abs, ent):
        with self._lock:
            rec = self._serving.setdefault(kind,
                                           {"checks": 0, "anomalies": 0})
            rec["checks"] += 1
            rec["finite_fraction"] = frac
            rec["max_abs"] = max_abs
            rec["argmax_entropy"] = ent
            rec["unix_ms"] = int(time.time() * 1e3)

    def serving_anomaly(self, kind):
        with self._lock:
            rec = self._serving.setdefault(kind,
                                           {"checks": 0, "anomalies": 0})
            rec["anomalies"] += 1

    def train_update(self, norm, frac, loss_finite, scale):
        with self._lock:
            t = self._train
            t["steps"] += 1
            t["grad_norm"] = norm
            t["grad_finite_fraction"] = frac
            t["loss_finite"] = bool(loss_finite >= 1.0)
            if scale is not None:
                t["loss_scale"] = scale
            drift = t["grad_norm_drift"]
            if math.isfinite(norm):
                ewma = t["grad_norm_ewma"]
                if ewma is None:
                    drift = 0.0
                    ewma = norm
                else:
                    drift = abs(norm - ewma) / max(abs(ewma), 1e-12)
                    ewma = (1.0 - _EWMA_ALPHA) * ewma + _EWMA_ALPHA * norm
                t["grad_norm_ewma"] = ewma
            t["grad_norm_drift"] = drift
            return drift if drift is not None else 0.0

    def shadow_update(self, kind, dtype, val):
        with self._lock:
            rec = self._shadow.get((kind, dtype))
            if rec is None:
                rec = {"count": 0, "last": 0.0, "max": 0.0,
                       "window": self._window_cls(maxlen=_SHADOW_WINDOW)}
                self._shadow[(kind, dtype)] = rec
            rec["count"] += 1
            rec["last"] = val
            if math.isfinite(val):
                rec["max"] = max(rec["max"], val)
                rec["window"].observe(val)

    def int8_update(self, kind, val):
        with self._lock:
            rec = self._int8.get(kind)
            if rec is None:
                rec = {"baseline": val, "last": val, "drift": 0.0,
                       "notes": 0}
                self._int8[kind] = rec
            rec["notes"] += 1
            rec["last"] = val
            base = rec["baseline"]
            rec["drift"] = abs(val - base) / max(abs(base), 1e-12)
            return rec["drift"]

    def canary_begin(self, ok: bool) -> bool:
        """Counter and sticky-corrupt update; True when this failure opens
        a NEW corruption episode (the anomaly fires once per episode)."""
        with self._lock:
            c = self._canary
            c["runs"] += 1
            newly = (not ok) and not c["corrupt"]
            if not ok:
                c["failures"] += 1
            c["ok"] = ok
            c["corrupt"] = not ok
            return newly

    def canary_finish(self, res: dict):
        with self._lock:
            self._canary["last"] = dict(res)

    def record_anomaly(self, kind, reason, trace_id, detail):
        with self._lock:
            a = self._anomalies
            a["total"] += 1
            a["by_reason"][reason] = a["by_reason"].get(reason, 0) + 1
            a["last"] = {"kind": kind, "reason": reason,
                         "trace_id": trace_id,
                         "unix_ms": int(time.time() * 1e3),
                         "detail": detail}

    def payload(self) -> dict:
        with self._lock:
            shadow = {}
            for (kind, dtype), rec in self._shadow.items():
                snap = rec["window"].snapshot((50, 95, 99))
                shadow[f"{kind}/{dtype}"] = {
                    "count": rec["count"], "last": rec["last"],
                    "max": rec["max"], "p50": snap["p50"],
                    "p95": snap["p95"], "p99": snap["p99"]}
            return {
                "serving": {k: dict(v) for k, v in self._serving.items()},
                "train": dict(self._train),
                "shadow": shadow,
                "int8": {k: dict(v) for k, v in self._int8.items()},
                "canary": dict(self._canary),
                "anomalies": {"total": self._anomalies["total"],
                              "by_reason": dict(
                                  self._anomalies["by_reason"]),
                              "last": self._anomalies["last"]},
                "pending": len(self._pending),
            }


_STATE_LOCK = threading.Lock()
_state_obj: Optional[_State] = None


def _state() -> _State:
    global _state_obj
    with _STATE_LOCK:
        if _state_obj is None:
            _state_obj = _State()
        return _state_obj


def reset_for_tests() -> None:
    """Fresh state store and default RNG (metric families persist:
    registration is get-or-create)."""
    global _state_obj
    with _STATE_LOCK:
        _state_obj = _State()
    set_rng_for_tests(None)


# ------------------------------------------------------- anomalies
def _emit_anomaly(kind: str, reason: str,
                  detail: Optional[dict] = None) -> Optional[str]:
    """One numerics anomaly: counter, tail-promoted error span in the
    trace flight recorder, and the xstats anomaly hook (arm-gated and
    rate-limited there, so a NaN storm starts exactly one /profilez
    capture). Returns the promoted trace id."""
    detail = {k: v for k, v in (detail or {}).items()
              if isinstance(v, (str, int, float, bool)) or v is None}
    try:
        _get_metrics().anomalies.labels(kind=kind, reason=reason).inc()
    except Exception:  # noqa: BLE001 - observability is garnish
        pass
    trace_id = None
    try:
        from . import tracing
        ctx = tracing.new_context(sampled=True)
        attrs = {"kind": kind, "reason": reason}
        attrs.update(detail)
        tracing.record_span(
            ctx, f"numerics::{reason}", stage="numerics",
            start_unix_ns=time.time_ns(), duration_ms=0.0,
            attrs=attrs, status="error", root=True)
        trace_id = ctx.trace_id
    except Exception:  # noqa: BLE001
        pass
    try:
        from . import xstats
        env = {"source": "numerics", "kind": kind, "reason": reason}
        env.update(detail)
        xstats.on_anomaly(env, trace_id)
    except Exception:  # noqa: BLE001
        pass
    _state().record_anomaly(kind, reason, trace_id, detail)
    return trace_id


# ------------------------------------------------- publication path
def _publish(entry: dict) -> None:
    """Host-side publication of one queued entry."""
    try:
        t = entry["type"]
        if t == "serving":
            _publish_serving(entry)
        elif t == "train":
            _publish_train(entry)
        elif t == "shadow":
            _publish_shadow(entry)
        elif t == "int8":
            _publish_int8(entry)
    except Exception:  # noqa: BLE001 - a broken scalar must never
        pass           # take down the path that enqueued it


def _floats(entry: dict):
    v = _values(entry)
    if isinstance(v, torch.Tensor):
        return [float(x) for x in v.reshape(-1).tolist()]
    return [float(x) for x in np.asarray(v, np.float64).reshape(-1)]


def _publish_serving(entry: dict) -> None:
    kind = entry["kind"]
    frac, max_abs, ent = _floats(entry)[:3]
    m = _get_metrics()
    m.finite_fraction.labels(kind=kind).set(frac)
    m.max_abs.labels(kind=kind).set(max_abs)
    m.argmax_entropy.labels(kind=kind).set(ent)
    _state().serving_update(kind, frac, max_abs, ent)
    if not math.isfinite(frac) or frac < 1.0:
        _state().serving_anomaly(kind)
        _emit_anomaly(kind, "nonfinite",
                      {"finite_fraction": frac, "max_abs": max_abs})


def _publish_train(entry: dict) -> None:
    vals = _floats(entry)
    norm, frac, loss_finite = vals[0], vals[1], vals[2]
    scale = vals[3] if len(vals) > 3 else None
    m = _get_metrics()
    if math.isfinite(norm):
        m.grad_norm.set(norm)
    drift = _state().train_update(norm, frac, loss_finite, scale)
    m.grad_norm_drift.set(drift)
    if scale is not None:
        m.loss_scale.set(scale)
    m.finite_fraction.labels(kind="train").set(frac)
    if not math.isfinite(norm) or frac < 1.0 or loss_finite < 1.0:
        _emit_anomaly("train", "nonfinite",
                      {"grad_norm_finite": math.isfinite(norm),
                       "grad_finite_fraction": frac,
                       "loss_finite": bool(loss_finite >= 1.0)})


def _publish_shadow(entry: dict) -> None:
    kind, dtype = entry["kind"], entry["dtype"]
    val = _floats(entry)[0]
    _get_metrics().shadow_divergence.labels(kind=kind, dtype=dtype).set(val)
    _state().shadow_update(kind, dtype, val)
    if not math.isfinite(val):
        _emit_anomaly(kind, "shadow_nonfinite", {"dtype": dtype})


def _publish_int8(entry: dict) -> None:
    kind = entry["kind"]
    val = _floats(entry)[0]
    drift = _state().int8_update(kind, val)
    _get_metrics().int8_scale_drift.labels(kind=kind).set(drift)


def _enqueue(entry: dict) -> None:
    stats = entry["stats"]
    if isinstance(stats, torch.Tensor):
        entry["stats"], entry["event"] = _stage(stats)
    for e in _state().push(entry):
        _publish(e)


def drain() -> int:
    """Publish every queued entry now (waits for their copies: the
    /numericsz scrape calls this; hot paths never do). Returns the number
    of entries published."""
    entries = _state().pop_all()
    for e in entries:
        _publish(e)
    return len(entries)


# ------------------------------------------------------- note APIs
def note_serving_logits(kind: str, logits) -> None:
    """Queue on-device health stats of one dispatch's logits ([B, vocab]
    or [B, S, vocab]); published one note later."""
    try:
        stats = logit_stats(logits)
    except Exception:  # noqa: BLE001 - garnish
        return
    try:
        _get_metrics().checks.labels(kind=kind).inc()
    except Exception:  # noqa: BLE001
        pass
    _enqueue({"type": "serving", "kind": kind, "stats": stats})


def note_train_step(stats, *, loss_scale=None) -> None:
    """Queue one train step's health vector ``[grad_norm,
    grad_finite_fraction, loss_is_finite]`` (device scalars from
    :func:`grad_stats`), with the live loss scale appended when given."""
    try:
        _get_metrics().checks.labels(kind="train").inc()
    except Exception:  # noqa: BLE001
        pass
    stats = torch.as_tensor(stats, dtype=torch.float32).reshape(-1)
    if loss_scale is not None:
        stats = torch.cat([stats, torch.as_tensor(
            loss_scale, dtype=torch.float32,
            device=stats.device).reshape(1)])
    _enqueue({"type": "train", "stats": stats})


def note_shadow_divergence(kind: str, dtype: str, value) -> None:
    """Queue one shadow-checked dispatch's max-abs logit divergence from
    the plain versions; ``dtype`` labels the live KV regime."""
    try:
        _get_metrics().shadow_checks.labels(kind=kind, dtype=dtype).inc()
    except Exception:  # noqa: BLE001
        pass
    _enqueue({"type": "shadow", "kind": kind, "dtype": dtype,
              "stats": value})


def note_int8_scales(kind: str, k, v) -> None:
    """Queue the mean |absmax scale| over the float scale planes of int8
    KV pools (per-layer lists of ``(values, scales)`` tuples, or stacked
    tuples): its drift against the first-seen baseline is the live
    int8-vs-float health signal."""
    try:
        from torch.utils._pytree import tree_leaves
        leaves = [a for a in tree_leaves((k, v))
                  if isinstance(a, torch.Tensor) and a.is_floating_point()]
        if not leaves:
            return
        s = _scale_summary(leaves)
    except Exception:  # noqa: BLE001 - garnish
        return
    _enqueue({"type": "int8", "kind": kind, "stats": s})


# --------------------------------------------------------- canary
def _record_canary(res: dict) -> None:
    newly = _state().canary_begin(ok=bool(res.get("ok")))
    m = _get_metrics()
    try:
        m.canary_runs.inc()
        m.canary_ok.set(1.0 if res.get("ok") else 0.0)
        if not res.get("ok"):
            m.canary_failures.inc()
    except Exception:  # noqa: BLE001
        pass
    if newly:
        res["trace_id"] = _emit_anomaly(
            "canary", "canary_failure",
            {"name": res.get("name"), "got": res.get("got"),
             "want": res.get("want"), "probe_ok":
                 (res.get("probe") or {}).get("ok")
                 if isinstance(res.get("probe"), dict) else None})
    _state().canary_finish(res)


def run_device_canary(record: bool = True, device=None) -> dict:
    """One deterministic checksum sweep on ``device`` (default: the card;
    ``"cpu"`` must be asked for), compared bit-exactly with the numpy
    golden twin. A mismatch is silent data corruption on this device (the
    workload is integer-only: no rounding freedom)."""
    t0 = time.perf_counter()
    got, err = None, None
    try:
        from ..framework.device import resolve_device
        got = int(canary_sweep(resolve_device(device))) & _CANARY_MASK
    except Exception as e:  # noqa: BLE001 - a crashed sweep is a
        err = repr(e)       # failure, not an exception to propagate
    want = canary_reference()
    res = {"ok": err is None and got == want, "got": got, "want": want,
           "ms": (time.perf_counter() - t0) * 1e3,
           "unix_ms": int(time.time() * 1e3)}
    if err is not None:
        res["error"] = err
    if record:
        _record_canary(res)
    return res


class CanaryRunner:
    """Per-worker canary sweeps on a period and on not-ready→ready
    transitions.

    ``probe`` (a backend's corruption self-check returning ``{"ok": bool,
    ...}``) replaces the device checksum when given; otherwise the sweep
    runs on ``canary_device`` (default: the card). ``on_corrupt`` fires
    once per corruption episode (the quarantine wiring lives in
    ``fleet.worker.arm_canary``)."""

    def __init__(self, *, name: str = "", period_s: float = 0.0,
                 probe: Optional[Callable[[], dict]] = None,
                 ready_fn: Optional[Callable[[], bool]] = None,
                 on_corrupt: Optional[Callable[[], None]] = None,
                 device: Optional[bool] = None, canary_device=None):
        self.name = name
        self.period_s = float(period_s)
        self._probe = probe
        self._ready_fn = ready_fn
        self._on_corrupt = on_corrupt
        self._device = (probe is None) if device is None else bool(device)
        self._canary_device = canary_device
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._corrupt = False
        self._fired = False
        self._last: Optional[dict] = None

    @property
    def corrupt(self) -> bool:
        with self._lock:
            return self._corrupt

    @property
    def last(self) -> Optional[dict]:
        with self._lock:
            return self._last

    def run_once(self) -> dict:
        res = (run_device_canary(record=False, device=self._canary_device)
               if self._device else {"ok": True})
        if self._probe is not None:
            try:
                p = self._probe()
            except Exception as e:  # noqa: BLE001 - a crashed probe
                p = {"ok": False, "error": repr(e)}   # is a failure
            res = dict(res)
            res["probe"] = p
            res["ok"] = bool(res.get("ok", True)) and bool(p.get("ok"))
        res.setdefault("unix_ms", int(time.time() * 1e3))
        res["name"] = self.name
        _record_canary(res)
        fire = False
        with self._lock:
            self._last = res
            if not res["ok"]:
                self._corrupt = True
                if not self._fired:
                    self._fired = True
                    fire = True
            else:
                # corruption cleared (e.g. a chaos restore): the NEXT
                # episode must fire on_corrupt again
                self._corrupt = False
                self._fired = False
        if fire and self._on_corrupt is not None:
            try:
                self._on_corrupt()
            except Exception:  # noqa: BLE001 - quarantine wiring must
                pass           # not kill the sweep loop
        return res

    def start(self) -> Optional["CanaryRunner"]:
        if self.period_s <= 0.0:
            return None
        t = threading.Thread(
            target=self._loop, daemon=True,
            name=f"numerics-canary-{self.name or 'worker'}")
        with self._lock:
            self._thread = t
        t.start()
        return self

    def _loop(self):
        next_due = time.monotonic()     # first sweep right away
        last_ready = None
        while not self._stop.is_set():
            ready = None
            if self._ready_fn is not None:
                try:
                    ready = bool(self._ready_fn())
                except Exception:  # noqa: BLE001
                    ready = None
            transition = ready is True and last_ready is False
            if ready is not None:
                last_ready = ready
            if transition or time.monotonic() >= next_due:
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 - keep sweeping
                    pass
                next_due = time.monotonic() + self.period_s
            self._stop.wait(min(max(self.period_s, 0.01), 0.05))

    def stop(self):
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=2.0)


# ------------------------------------------------------- /numericsz
def numericsz_payload() -> dict:
    """The /numericsz document: knobs, per-kind serving health, train
    health, shadow-divergence percentiles, int8 drift, canary state and
    the anomaly ledger (with the last promoted trace id). A scrape drains
    the deferred-publication queue first."""
    drain()
    doc = _state().payload()
    doc["enabled"] = enabled()
    doc["rates"] = {
        "tripwire": tripwire_rate(),
        "shadow": shadow_rate(),
        "check_nan_inf": bool(_flag("FLAGS_check_nan_inf", False)),
        "canary_period_s": float(
            _flag("FLAGS_numerics_canary_period_s", 0.0) or 0.0),
    }
    return doc
