"""The port's metric registry and exposition against ``paddle_tpu``'s.

The same sequence of counter, gauge and histogram operations, drawn from a
seeded numpy generator, runs on a fresh ``MetricRegistry`` of each package;
the Prometheus text must be byte for byte the reference's and the JSON
mirror equal. Label and help escaping, read-time gauges (and a probe that
raises), scrape-time collectors, NaN and infinite values, age-bounded
histogram windows under an injected clock and ``sanitize_metric_name`` are
held the same way.
"""
# pdlint: disable=metric_discipline  (registry unit tests register
# synthetic family names, an invalid one among them, on purpose)
import numpy as np
import pytest

from paddle_tpu.observability import exposition as jexp
from paddle_tpu.observability import registry as jreg
from paddle_tpu_torch.observability import exposition as pexp
from paddle_tpu_torch.observability import registry as preg

LABEL_VALUES = ("a", "b", 'q"uote', "new\nline", "back\\slash", "")


def _ops(seed: int, n: int = 200):
    """A reproducible list of registry operations."""
    rng = np.random.RandomState(seed)
    fams = []
    for i in range(rng.randint(3, 7)):
        kind = ("counter", "gauge", "histogram")[i % 3]
        labels = tuple(f"l{j}" for j in range(rng.randint(0, 3)))
        help_ = rng.choice(["", "plain help", "multi\nline \\ help"])
        buckets = sorted(set(np.round(rng.uniform(0.1, 100, 4), 3)))
        fams.append((kind, f"fam_{seed}_{i}", str(help_), labels,
                     tuple(float(b) for b in buckets)))
    ops = [("create",) + f for f in fams]
    for _ in range(n):
        kind, name, _, labels, _ = fams[rng.randint(len(fams))]
        values = tuple(LABEL_VALUES[rng.randint(len(LABEL_VALUES))]
                       for _ in labels)
        x = float(np.round(rng.uniform(-5, 500), 4))
        if kind == "counter":
            ops.append(("inc", name, values, abs(x)))
        elif kind == "gauge":
            special = rng.randint(12)
            x = float("nan") if special == 0 else \
                float("inf") if special == 1 else x
            ops.append(("set", name, values, x))
        else:
            ops.append(("observe", name, values, abs(x)))
    return ops


def _apply(mod, ops, now=None):
    reg = mod.MetricRegistry()
    fams = {}
    for op in ops:
        if op[0] == "create":
            _, kind, name, help_, labels, buckets = op
            if kind == "histogram":
                kw = dict(buckets=buckets, window=64)
                if now is not None:
                    kw.update(max_age_s=10.0, now=now)
                fams[name] = reg.histogram(name, help_, labels, **kw)
            else:
                fams[name] = getattr(reg, kind)(name, help_, labels)
            continue
        verb, name, values, x = op
        child = fams[name].labels(*values)
        getattr(child, verb)(x)
    return reg


@pytest.mark.parametrize("seed", range(6))
def test_text_and_json_match_reference(seed):
    ops = _ops(seed)
    preg_, jreg_ = _apply(preg, ops), _apply(jreg, ops)
    assert pexp.prometheus_text(preg_) == jexp.prometheus_text(jreg_)
    assert pexp.json_text(preg_) == jexp.json_text(jreg_)
    assert pexp.json_text(preg_, indent=1) == jexp.json_text(jreg_, indent=1)
    assert pexp.PROMETHEUS_CONTENT_TYPE == jexp.PROMETHEUS_CONTENT_TYPE


@pytest.mark.parametrize("seed", range(3))
def test_age_bounded_windows_match_reference(seed):
    """Histogram windows bounded by age under an injected clock: the JSON
    mirror's window percentiles equal the reference's as samples age
    out."""
    ops = _ops(seed + 10, n=120)
    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    for step in range(4):
        t["now"] = 0.0
        preg_, jreg_ = _apply(preg, ops, clock), _apply(jreg, ops, clock)
        t["now"] = 4.0 * step
        assert pexp.json_text(preg_) == jexp.json_text(jreg_)


def test_read_time_gauges_and_collectors_match_reference():
    outs = []
    for mod, exp in ((preg, pexp), (jreg, jexp)):
        reg = mod.MetricRegistry()
        g = reg.gauge("live_depth", "read at scrape", ("q",))
        g.labels(q="x").set_function(lambda: 7.5)
        g.labels(q="broken").set_function(lambda: 1 / 0)
        scraped = reg.gauge("scraped", "set by a collector")
        calls = []

        def collector(r, calls=calls, scraped=scraped):
            calls.append(1)
            scraped.set(len(calls))
        reg.register_collector(collector, name="c")
        reg.register_collector(collector, name="c")     # idempotent
        reg.register_collector(lambda r: 1 / 0, name="bad")
        c = reg.counter("plain_total")
        c.inc(3)
        h = reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(5.0)
        h.observe(50.0)
        first = exp.prometheus_text(reg)
        reg.unregister_collector("c")
        second = exp.prometheus_text(reg)
        outs.append((first, second, exp.json_text(reg), len(calls),
                     c.value, round(h.labels().window_sum(), 6),
                     h.labels().percentile(50)))
    assert outs[0] == outs[1]
    assert outs[0][3] == 1          # the removed collector ran once


def test_registry_errors_match_reference():
    for mod in (preg, jreg):
        reg = mod.MetricRegistry()
        reg.counter("x_total", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("x_total", labelnames=("b",))
        with pytest.raises(ValueError):
            reg.counter("bad name")
        fam = reg.get("x_total")
        with pytest.raises(ValueError):
            fam.labels("1", "2")
        with pytest.raises(ValueError):
            fam.labels(b="1")
        assert fam.get(a="never") is None and fam.label_values() == []
        fam.labels(a="k").inc()
        fam.clear(a="k")
        assert fam.items() == []
        with pytest.raises(ValueError):
            fam.clear(z="k")


def test_sanitize_metric_name_matches_reference():
    rng = np.random.RandomState(3)
    alphabet = list("abcXYZ019_:-. /é")
    names = ["", "9lives", "ok_name", "a-b.c"] + [
        "".join(rng.choice(alphabet, rng.randint(0, 12)))
        for _ in range(300)]
    for n in names:
        assert preg.sanitize_metric_name(n) == jreg.sanitize_metric_name(n)


def test_percentile_window_matches_reference():
    rng = np.random.RandomState(4)
    t = {"now": 0.0}
    wins = [mod.PercentileWindow(50, max_age_s=3.0, now=lambda: t["now"])
            for mod in (preg, jreg)]
    for i in range(400):
        t["now"] = i * 0.05
        v = float(rng.exponential(10))
        for w in wins:
            w.observe(v)
        if i % 37 == 0:
            snaps = [w.snapshot((50, 90, 99)) for w in wins]
            assert snaps[0] == snaps[1]
            assert wins[0].max() == wins[1].max()
            assert wins[0].percentile(75) == wins[1].percentile(75)
    for w in wins:
        w.clear()
    assert len(wins[0]) == len(wins[1]) == 0
