"""The port's SLO monitor and continuous step profiler against
``paddle_tpu``'s, with injected clocks.

SLOs: the same latency samples land in a histogram of a fresh registry of
each package; ``SLOMonitor`` evaluates at the same injected times, so the
``/sloz`` payloads, the burn-rate gauges, the alert transitions the sinks
receive and the fleet merge must be equal. Step profiles: the same step
times (with stragglers) go through a ``StepProfiler`` of each package with
injected ``now``/``wall_ns``; the envelopes, the straggler flags, the
summaries and the straggler spans must be equal. The reference's envelope
carries ``device_peak_bytes`` only where a device-memory gauge exists; the
port's comes from the CUDA allocator and is absent for the CPU.
"""
import itertools

import numpy as np
import pytest

from paddle_tpu.observability import registry as jreg
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import stepprof as jsp
from paddle_tpu.observability import tracing as jtr
from paddle_tpu_torch.observability import registry as preg
from paddle_tpu_torch.observability import slo as pslo
from paddle_tpu_torch.observability import stepprof as psp
from paddle_tpu_torch.observability import tracing as ptr

PKGS = ((preg, pslo, psp, ptr), (jreg, jslo, jsp, jtr))


@pytest.fixture(autouse=True)
def restore_process_state():
    names = [p[3].process_name() for p in PKGS]
    for p in PKGS:
        p[3].set_process_name("proc-s")
        p[3].clear_exemplars()
    yield
    for p, n in zip(PKGS, names):
        p[3].set_process_name(n)
        p[3].clear_exemplars()


def _slo_run(reg_mod, slo_mod, tr_mod, seed):
    rng = np.random.RandomState(seed)
    reg = reg_mod.MetricRegistry()
    hist = reg.histogram("paddle_serving_latency_ms", "latency",
                         ("server",))
    t = {"now": 0.0}
    mon = slo_mod.SLOMonitor(registry=reg, now=lambda: t["now"])
    rules = (slo_mod.BurnRule("fast", 60.0, 600.0, 2.0),
             slo_mod.BurnRule("slow", 600.0, 3600.0, 1.0, severity="ticket"))
    mon.add(slo_mod.LatencySLO("p99", "paddle_serving_latency_ms", 100.0,
                               0.9, labels={"server": "a"},
                               burn_rules=rules))
    mon.add(slo_mod.LatencySLO("direct", "no_such_histogram", 50.0, 0.95,
                               windows=(30.0, 300.0)))
    alerts = []
    mon.add_alert_sink("rec", alerts.append)
    mon.add_alert_sink("bad", lambda a: 1 / 0)
    docs = []
    for step in range(40):
        t["now"] = step * 45.0
        bad_phase = 10 <= step < 22
        for _ in range(rng.randint(5, 30)):
            lat = rng.exponential(300 if bad_phase else 30)
            hist.labels(server="a" if rng.rand() < 0.8 else "b").observe(
                lat)
            mon.observe("direct", lat, warmup=bool(rng.rand() < 0.1))
        if step % 3 == 0:
            tr_mod.record_exemplar("paddle_serving_latency_ms",
                                   float(rng.exponential(300)),
                                   f"{step:032x}")
        docs.append(mon.sloz_payload())
    gauges = [(labels, child.value) for labels, child in
              reg.get("paddle_slo_burn_rate").collect()]
    excluded = reg.get("paddle_slo_samples_excluded_total").labels(
        slo="direct").value
    merged = slo_mod.merge_sloz_payloads(docs[-1], {"r1": docs[-2],
                                                     "r0": docs[-5]})
    with pytest.raises(ValueError):
        mon.add(slo_mod.LatencySLO("p99", "x", 1.0, 0.5))
    with pytest.raises(KeyError):
        mon.observe("nope", 1.0)
    with pytest.raises(ValueError):
        slo_mod.LatencySLO("full", "x", 1.0, 1.0)
    mon.remove("direct")
    return docs, alerts, gauges, excluded, merged, [s.name
                                                    for s in mon.slos()]


@pytest.mark.parametrize("seed", range(3))
def test_sloz_matches_reference(seed):
    outs = [_slo_run(r, s, tr, seed) for r, s, _, tr in PKGS]
    assert outs[0] == outs[1]
    docs, alerts = outs[0][0], outs[0][1]
    assert any(a["firing"] for a in alerts)        # the bad phase fired
    assert any(not a["firing"] for a in alerts)    # and resolved
    assert docs[-1]["process"] == "proc-s"


def test_default_monitor_and_helpers_match_reference():
    outs = []
    for reg_mod, slo_mod, _, _ in PKGS:
        prev = slo_mod.set_default_monitor(slo_mod.SLOMonitor(
            registry=reg_mod.MetricRegistry(), now=lambda: 5.0))
        try:
            slo_mod.latency_slo("lat", threshold_ms=25.0,
                                target_fraction=0.99)
            got = []
            slo_mod.add_alert_sink("s", got.append)
            doc = slo_mod.sloz_payload()
            slo_mod.remove_alert_sink("s")
            outs.append((doc, [r.to_dict() for r in
                               slo_mod.DEFAULT_BURN_RULES]))
        finally:
            slo_mod.set_default_monitor(prev)
    assert outs[0] == outs[1]


def _step_times(seed, n=160):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = ("decode", "prefill", "verify")[i % 3]
        ms = float(np.round(rng.normal(20, 1.5), 3))
        if i in (60, 61, 120) or (i > 100 and rng.rand() < 0.03):
            ms *= 8                                   # a straggler
        out.append((kind, ms, i))
    return out


def _prof_run(reg_mod, sp_mod, tr_mod, seed, ids):
    reg = reg_mod.MetricRegistry()
    t = {"now": 0.0, "wall": 1_700_000_000_000_000_000}
    prof = sp_mod.StepProfiler(window=64, anomaly_k=4.0, min_samples=16,
                               registry=reg, now=lambda: t["now"],
                               wall_ns=lambda: t["wall"])
    buf = tr_mod.SpanBuffer(max_spans=1000)
    prev = tr_mod.set_default_buffer(buf)
    try:
        envs = []
        for kind, ms, i in _step_times(seed):
            t["now"] += ms / 1e3
            t["wall"] += int(ms * 1e6)
            env = prof.record_step(ms, kind=kind, step=i, host_ms=ms / 4,
                                   device_ms=ms / 2, occupancy=i % 8,
                                   kv_pages_used=i,
                                   attrs={"note": kind})
            env.pop("device_peak_bytes", None)
            envs.append(env)
    finally:
        tr_mod.set_default_buffer(prev)
    spans = [{k: v for k, v in s.items() if k not in ("tid",)}
             for s in buf.snapshot()]
    anomalies = {labels["kind"]: child.value for labels, child in
                 reg.get("paddle_step_anomalies_total").collect()}
    wall = reg.get("paddle_step_wall_ms").labels(kind="decode")
    summary = prof.summary()
    for e in summary["recent_anomalies"]:
        e.pop("device_peak_bytes", None)
    return (envs, prof.envelopes(kind="decode", limit=10), summary, spans,
            anomalies, wall.count, round(wall.sum, 6))


@pytest.mark.parametrize("seed", range(3))
def test_step_profiles_match_reference(seed, monkeypatch):
    outs = []
    for reg_mod, _, sp_mod, tr_mod in PKGS:
        counter = itertools.count(1)
        monkeypatch.setattr(tr_mod, "_gen_span_id",
                            lambda c=counter: f"{next(c):016x}")
        monkeypatch.setattr(tr_mod, "_gen_trace_id",
                            lambda c=counter: f"{next(c):032x}")
        outs.append(_prof_run(reg_mod, sp_mod, tr_mod, seed, counter))
    assert outs[0] == outs[1]
    envs, _, summary, spans, anomalies = outs[0][:5]
    flagged = [e for e in envs if "anomaly" in e]
    assert flagged and sum(anomalies.values()) == len(flagged)
    assert {s["name"] for s in spans} == {"stepprof::straggler"}
    assert all("device_peak_bytes" not in e
               for e in psp.StepProfiler(
                   registry=preg.MetricRegistry()).envelopes())


def test_port_envelope_has_no_device_peak_on_the_cpu():
    prof = psp.StepProfiler(registry=preg.MetricRegistry())
    assert "device_peak_bytes" not in prof.record_step(1.0, device="cpu")
    assert "device_peak_bytes" not in prof.record_step(1.0)
    prev = psp.set_default_profiler(prof)
    try:
        psp.record_step(2.0, kind="decode")
        assert psp.default_profiler().summary()["total_steps"] == 3
    finally:
        psp.set_default_profiler(prev)
    prof.clear()
    assert prof.summary()["ring"] == 0
