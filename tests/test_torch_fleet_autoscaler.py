"""The port's ``FleetAutoscaler`` against ``paddle_tpu``'s: the same
injected clock, burn-rate alerts, queue depths and occupancies go to both,
over a fake supervisor each; the decisions, the decision logs
(``snapshot()``), the ``scale_to`` calls and the ``paddle_autoscale_*``
metric text (each on a fresh registry) must be equal. Then the port's
autoscaler on ``/schedz`` once registered, and on a real ``SLOMonitor``'s
alert sinks.
"""
import pytest

from paddle_tpu.observability import exposition as jexpo
from paddle_tpu.observability.registry import MetricRegistry as JRegistry
from paddle_tpu.serving import scheduling as jsch
from paddle_tpu_torch.observability import exposition as pexpo
from paddle_tpu_torch.observability.registry import \
    MetricRegistry as PRegistry
from paddle_tpu_torch.serving import scheduling as psch


class _FakeSup:
    def __init__(self, n):
        self.n = n
        self.calls = []

    @property
    def replica_ids(self):
        return list(range(self.n))

    def scale_to(self, n):
        self.calls.append(int(n))
        self.n = int(n)


class _FakeMonitor:
    def __init__(self):
        self.sinks = {}

    def add_alert_sink(self, name, fn):
        self.sinks[name] = fn

    def remove_alert_sink(self, name):
        self.sinks.pop(name, None)


def _alert(rule, firing):
    return {"slo": "s", "rule": rule, "firing": firing,
            "severity": "page" if rule == "fast_burn" else "ticket"}


def _square_wave(t):
    return [("fast_burn", t % 20 < 10)], 0.0, 0.0


def _queue_then_quiet(t):
    depth = 40.0 if 10 <= t < 40 else (9.0 if t < 60 else 0.0)
    return [], depth, 0.0


def _occupancy_and_slow_burn(t):
    alerts = [("slow_burn", 50 <= t < 120)]
    return alerts, 0.0, (0.95 if t < 30 else 0.2)


def _flapping_sensor(t):
    # a dead queue sensor every 7th step reads 0, the loop lives on
    return [("fast_burn", 100 <= t < 105)], (30.0 if t < 20 else 1.0), 0.5


SCENARIOS = {"square_wave": _square_wave,
             "queue_then_quiet": _queue_then_quiet,
             "occupancy_and_slow_burn": _occupancy_and_slow_burn,
             "flapping_sensor": _flapping_sensor}


def _run(sch, expo, reg_cls, scenario, start_n, steps, **kw):
    clock = [0.0]
    sup, mon = _FakeSup(start_n), _FakeMonitor()
    sig = {"depth": 0.0, "occ": 0.0}

    def depth():
        if scenario is _flapping_sensor and int(clock[0]) % 7 == 0:
            raise RuntimeError("sensor down")
        return sig["depth"]

    reg = reg_cls()
    asc = sch.FleetAutoscaler(
        sup, monitor=mon, queue_depth_fn=depth,
        occupancy_fn=lambda: sig["occ"], now=lambda: clock[0],
        name="t_asc", metrics=sch.AutoscaleMetrics("t_asc", registry=reg),
        **kw)
    sink = mon.sinks["autoscaler-t_asc"]
    decisions = []
    for t in range(steps):
        clock[0] = float(t)
        alerts, sig["depth"], sig["occ"] = scenario(t)
        for rule, firing in alerts:
            sink(_alert(rule, firing))
        decisions.append(asc.evaluate())
    asc.stop()
    return {"decisions": decisions, "calls": sup.calls,
            "snapshot": asc.snapshot(), "sinks": sorted(mon.sinks),
            "metrics": expo.prometheus_text(reg)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_and_log_equal_reference(name):
    kw = dict(min_replicas=1, max_replicas=4, cooldown_s=15.0,
              scale_in_quiet_s=30.0, queue_high=16.0, occupancy_high=0.85)
    got = _run(psch, pexpo, PRegistry, SCENARIOS[name], 2, 200, **kw)
    want = _run(jsch, jexpo, JRegistry, SCENARIOS[name], 2, 200, **kw)
    assert got == want
    assert any(d is not None for d in got["decisions"])
    assert got["sinks"] == []       # stop() removed the alert sink


def test_square_wave_marches_out_and_never_flaps():
    got = _run(psch, pexpo, PRegistry, _square_wave, 2, 300,
               min_replicas=2, max_replicas=4, cooldown_s=30.0,
               scale_in_quiet_s=120.0)
    dirs = [d["direction"] for d in got["decisions"] if d]
    assert dirs == ["out", "out"] and got["calls"] == [3, 4]


def test_defaults_come_from_the_flags():
    p = psch.FleetAutoscaler(_FakeSup(1), name="t_asc_flags",
                             metrics=psch.AutoscaleMetrics(
                                 "t_asc_flags", registry=PRegistry()))
    j = jsch.FleetAutoscaler(_FakeSup(1), name="t_asc_flags",
                             metrics=jsch.AutoscaleMetrics(
                                 "t_asc_flags", registry=JRegistry()))
    for attr in ("min_replicas", "max_replicas", "cooldown_s",
                 "scale_in_quiet_s", "queue_high", "occupancy_high",
                 "interval_s", "step"):
        assert getattr(p, attr) == getattr(j, attr), attr


def test_schedz_lists_a_registered_autoscaler_and_slo_sinks_drive_it():
    from paddle_tpu_torch.observability.slo import (BurnRule, LatencySLO,
                                                    SLOMonitor)
    reg = PRegistry()
    mon = SLOMonitor(registry=reg)
    mon.add(LatencySLO("t_asc_slo", metric="t_asc_lat_ms", threshold_ms=10,
                       target_fraction=0.9,
                       burn_rules=(BurnRule("fast_burn", 1.0, 2.0, 2.0,
                                            "page"),)))
    sup = _FakeSup(1)
    asc = psch.FleetAutoscaler(sup, monitor=mon, min_replicas=1,
                               max_replicas=3, cooldown_s=0.0,
                               name="t_asc_schedz",
                               metrics=psch.AutoscaleMetrics(
                                   "t_asc_schedz", registry=reg))
    psch.register_autoscaler(asc)
    try:
        entry = psch.schedz_payload()["autoscalers"]["t_asc_schedz"]
        assert entry["replicas"] == 1 and entry["decisions"] == []
        # every observation after the first evaluation breaches: the
        # fast-burn page fires at the next one
        mon.evaluate(t=100.0)
        for _ in range(20):
            mon.observe("t_asc_slo", 50.0)
        mon.evaluate(t=103.0)
        assert asc.evaluate()["reason"] == "fast_burn_page"
        assert sup.calls == [2]
        entry = psch.schedz_payload()["autoscalers"]["t_asc_schedz"]
        assert entry["decisions"][-1]["to"] == 2
        assert entry["firing"] == [{"slo": "t_asc_slo",
                                    "rule": "fast_burn"}]
    finally:
        asc.stop()
        del asc
    import gc
    gc.collect()
    assert "t_asc_schedz" not in psch.schedz_payload()["autoscalers"]
