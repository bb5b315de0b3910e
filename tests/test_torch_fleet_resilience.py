"""The port's fleet resilience layer and fleet metrics against
``paddle_tpu``'s, under injected clocks.

Both packages' ``resilience`` modules read ``time.monotonic``; each test
swaps in one fake clock for both, drives the same sequence of operations
and compares what the objects say: circuit-breaker transitions and
snapshots (half-open probing, the latency threshold, ``force_open``),
``Deadline`` arithmetic, backoff sequences from the same ``random.Random``
seed, ``latency_quantile``, the wedge monitor's ages and the watchdog's one
firing; ``FleetMetrics``' Prometheus text and snapshot after the same
operations, each on a fresh registry, and ``merge_prometheus_texts``.
"""
import random
import threading
import types

import pytest

from paddle_tpu.observability import exposition as jexpo
from paddle_tpu.observability.registry import MetricRegistry as JRegistry
from paddle_tpu.serving.fleet import metrics as jmetrics
from paddle_tpu.serving.fleet import resilience as jres
from paddle_tpu_torch.observability import exposition as pexpo
from paddle_tpu_torch.observability.registry import \
    MetricRegistry as PRegistry
from paddle_tpu_torch.serving.fleet import metrics as pmetrics
from paddle_tpu_torch.serving.fleet import resilience as pres


@pytest.fixture()
def clock(monkeypatch):
    """One fake monotonic clock (seconds) for both packages."""
    now = [1000.0]
    fake = types.SimpleNamespace(monotonic=lambda: now[0])
    for mod in (pres, jres):
        monkeypatch.setattr(mod, "time", fake)
    return now


def _breaker_drill(res, now, **kw):
    trans = []
    br = res.CircuitBreaker(on_transition=lambda a, b: trans.append((a, b)),
                            **kw)
    log = []

    def note(tag):
        snap = br.snapshot()
        snap["open_remaining_ms"] = round(snap["open_remaining_ms"], 6)
        log.append((tag, br.state, snap))

    for ok, ms in ((True, 5.0), (False, None), (True, 50.0), (False, None),
                   (True, 1.0), (False, None)):
        br.record(ok, ms)
        note("record")
    log.append(("allow_open", br.allow()))
    now[0] += 0.4
    note("cooling")
    now[0] += 0.7
    log.append(("probe", br.allow(), br.allow()))     # one slot only
    br.release_probe()
    log.append(("probe_again", br.allow()))
    br.record(False)                                  # probe fails
    note("reopened")
    now[0] += 1.2
    log.append(("probe2", br.allow()))
    br.record(True, 3.0)                              # probe succeeds
    note("closed")
    br.force_open()
    note("forced")
    log.append(("window", br.latency_window(), br.opens))
    return log, trans


@pytest.mark.parametrize("kw", [
    dict(window=4, failure_ratio=0.5, min_samples=4, open_ms=1000.0),
    dict(window=8, failure_ratio=0.25, min_samples=2, open_ms=1000.0,
         latency_threshold_ms=20.0),
], ids=["ratio", "latency_threshold"])
def test_breaker_transitions_equal_reference(clock, kw):
    got = _breaker_drill(pres, clock, **kw)
    clock[0] = 1000.0
    want = _breaker_drill(jres, clock, **kw)
    assert got == want
    assert ("closed", "open") in got[1] and ("half_open", "closed") in got[1]


def test_breaker_defaults_come_from_the_flags():
    p, j = pres.CircuitBreaker(), jres.CircuitBreaker()
    for attr in ("window", "failure_ratio", "min_samples", "open_ms",
                 "latency_threshold_ms"):
        assert getattr(p, attr) == getattr(j, attr), attr


def _deadline_drill(res, now):
    d = res.Deadline(250.0)
    out = [d.bounded, d.remaining_ms(), d.expired(), d.clamp_ms(100.0),
           d.clamp_ms(400.0)]
    now[0] += 0.2
    out += [d.remaining_ms(), d.expired(), d.clamp_ms(100.0)]
    now[0] += 0.1
    out += [d.remaining_ms(), d.expired(), d.clamp_ms(100.0)]
    never = res.Deadline.never()
    out += [never.bounded, never.remaining_ms(), never.expired(),
            never.clamp_ms(7.0), res.Deadline(0).bounded]
    return [round(x, 6) if isinstance(x, float) else x for x in out]


def test_deadline_arithmetic_equals_reference(clock):
    got = _deadline_drill(pres, clock)
    clock[0] = 1000.0
    assert got == _deadline_drill(jres, clock)
    assert got[2] is False and got[9] is True


@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_sequence_from_a_seed_equals_reference(seed):
    pr, jr = random.Random(seed), random.Random(seed)
    got = [pres.retry_backoff_ms(a, 10.0, 500.0, pr) for a in range(10)]
    want = [jres.retry_backoff_ms(a, 10.0, 500.0, jr) for a in range(10)]
    assert got == want
    assert all(0 <= x <= min(500.0, 10.0 * 2 ** a)
               for a, x in enumerate(got))


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
def test_latency_quantile_equals_reference(q):
    xs = random.Random(3).sample(range(1000), 37)
    assert pres.latency_quantile(xs, q) == jres.latency_quantile(xs, q)
    assert pres.latency_quantile([], q) is None


def test_wedge_monitor_ages_equal_reference(clock):
    def drill(res):
        m = res.WedgeMonitor()
        out = [m.oldest_age_ms(), m.inflight]
        a = m.begin()
        clock[0] += 0.05
        b = m.begin()
        clock[0] += 0.1
        out += [round(m.oldest_age_ms(), 6), m.inflight]
        m.end(a)
        m.end(a)            # a second end of one token counts once
        out += [round(m.oldest_age_ms(), 6), m.inflight, m.completed]
        m.end(b)
        return out + [m.oldest_age_ms(), m.completed]
    got = drill(pres)
    clock[0] = 1000.0
    assert got == drill(jres)
    assert got[2] == 150.0 and got[4] == 100.0


def test_watchdog_fires_once_on_the_oldest_dispatch():
    """A dispatch left open past the timeout: the watchdog fires once in
    each package, waited for on the hook (no sleep taken as an oracle)."""
    for res in (pres, jres):
        mon = res.WedgeMonitor()
        fired = threading.Event()
        calls = []
        wd = res.WedgeWatchdog(mon, timeout_ms=30.0, poll_interval_s=0.005,
                               on_wedge=lambda: (calls.append(1),
                                                 fired.set()))
        assert wd.enabled and not wd.wedged
        wd.start()
        mon.begin()
        assert fired.wait(10.0)
        assert wd.wedged and wd.wedge_count == 1
        mon.begin()
        wd.stop()
        assert calls == [1]
        assert not res.WedgeWatchdog(mon, timeout_ms=0).enabled


def _metrics_drill(mod, reg):
    m = mod.FleetMetrics("t_fm", registry=reg)
    m.count("routed", 5)
    m.count("completed", 4)
    m.count("failed")
    m.count_retry("queue_full")
    m.count_retry("unavailable")
    m.count_shed("0")
    m.count_hedge("fired", 2)
    m.count_hedge("won")
    m.count_deadline_reject("router", 3)
    m.count_breaker_transition("1", "open")
    m.count_breaker_transition("1", "closed")
    m.count_restart()
    m.count_swap("replica_reloaded")
    m.count_swap("completed")
    m.set_outstanding("0", 3)
    m.set_outstanding("1", 0)
    m.set_replica_states(2, 1, 2, 1)
    for ms in (1.5, 12.0, 250.0, 3.25):
        m.observe_latency(ms)
    m.drop_replica("1")
    return m.snapshot()


def test_fleet_metrics_text_and_snapshot_equal_reference():
    preg, jreg = PRegistry(), JRegistry()
    psnap = _metrics_drill(pmetrics, preg)
    jsnap = _metrics_drill(jmetrics, jreg)
    assert psnap == jsnap
    ptext, jtext = pexpo.prometheus_text(preg), jexpo.prometheus_text(jreg)
    assert ptext == jtext
    assert 'paddle_fleet_sheds_total{replica="0",router="t_fm"} 1' in ptext
    assert 'replica="1"' not in ptext


def test_merge_prometheus_texts_equals_reference():
    a = ("# HELP x_total things\n# TYPE x_total counter\n"
         'x_total{k="v"} 3\nx_plain 1\n')
    b = "# HELP x_total things\n# TYPE x_total counter\nx_total 9\n\n"
    own = "# TYPE r gauge\nr 2\n"
    for texts, o in (({"0": a, "1": b}, own), ({"1": b, "0": a}, None),
                     ({}, own)):
        got = pmetrics.merge_prometheus_texts(texts, own=o)
        assert got == jmetrics.merge_prometheus_texts(texts, own=o)
    merged = pmetrics.merge_prometheus_texts({"0": a, "1": b}, own=own)
    assert 'x_total{replica="0",k="v"} 3' in merged
    assert 'x_total{replica="1"} 9' in merged
    assert merged.count("# TYPE x_total counter") == 1
