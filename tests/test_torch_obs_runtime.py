"""The port's runtime collectors (``paddle_tpu_torch/observability/
runtime.py``) and the telemetry endpoint's new sections, on the CPU.

- the kernel library's build is the port's one run-time compile: one
  ``paddle_jax_events_total``/``paddle_jax_event_duration_seconds`` event
  per build, reported at install for a build that came before it, and
  recorded in the goodput ledger's ``compile`` category;
- span mirroring puts every ``RecordEvent`` span into
  ``paddle_profiler_span_ms{span=}``, the family the reference's makes;
- ``paddle_build_info`` is the reference's family with the port's labels
  (torch, CUDA and driver versions, the device, the kernel library's
  hash); the device-memory collector installs nothing without CUDA;
- ``start_telemetry_server`` installs the collectors, ``/statusz`` gains
  the numerics section, and ``/metrics`` carries the build info.
"""
import json
import time
import urllib.request

import pytest

from paddle_tpu.observability import registry as jreg
from paddle_tpu.observability import runtime as jrt
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.observability import goodput
from paddle_tpu_torch.observability import httpd as phttpd
from paddle_tpu_torch.observability import registry as preg
from paddle_tpu_torch.observability import runtime as prt
from paddle_tpu_torch.ops import _build

OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _families(reg):
    return {f.name: (f.kind, f.labelnames) for f in reg.collect()}


def _child(reg, name, **labels):
    fam = reg.get(name)
    for lab, child in fam.collect():
        if all(lab.get(k) == v for k, v in labels.items()):
            return child
    return None


@pytest.fixture
def fresh_monitoring(monkeypatch):
    """A process that has not installed the compile listener yet, with a
    build of 1.5 s behind it (begun 10 s ago), and a fresh ledger started
    20 s ago."""
    now = time.monotonic()
    monkeypatch.setattr(prt, "_monitoring_installed", False)
    monkeypatch.setattr(_build, "_LISTENERS", [])
    monkeypatch.setattr(_build, "_BUILD_SECONDS", 1.5)
    monkeypatch.setattr(_build, "_BUILD_STARTED", now - 10.0)
    ledger = goodput.GoodputLedger(registry=preg.MetricRegistry())
    ledger.start(t=now - 20.0)
    prev = goodput.set_default_ledger(ledger)
    yield ledger
    goodput.set_default_ledger(prev)


def test_kernel_build_is_one_compile_event(fresh_monitoring, monkeypatch):
    reg = preg.MetricRegistry()
    assert prt.install_jax_monitoring(reg)
    assert prt.install_jax_monitoring(reg)        # once per process
    ev = prt.KERNEL_BUILD_EVENT
    assert "compil" in ev
    assert _child(reg, "paddle_jax_events_total", event=ev).value == 1
    hist = _child(reg, "paddle_jax_event_duration_seconds", event=ev)
    assert hist.count == 1 and hist.sum == pytest.approx(1.5)
    # a later build in this process is one more event
    for fn in list(_build._LISTENERS):
        fn(2.0, time.monotonic() - 2.0)
    assert _child(reg, "paddle_jax_events_total", event=ev).value == 2
    rep = fresh_monitoring.report()
    assert rep["categories_s"]["compile"] == pytest.approx(3.5)
    # a ledger started after a build began does not take its seconds
    # (they lie outside its window): the event still counts
    late = goodput.GoodputLedger(registry=preg.MetricRegistry()).start()
    goodput.set_default_ledger(late)
    for fn in list(_build._LISTENERS):
        fn(4.0, time.monotonic() - 4.0)
    assert late.report()["categories_s"]["compile"] == 0.0
    assert _child(reg, "paddle_jax_events_total", event=ev).value == 3
    jr = jreg.MetricRegistry()
    monkeypatch.setattr(jrt, "_jax_monitoring_installed", False)
    assert jrt.install_jax_monitoring(jr)
    jfam, pfam = _families(jr), _families(reg)
    for name in ("paddle_jax_events_total",
                 "paddle_jax_event_duration_seconds"):
        assert pfam[name] == jfam[name]


def test_span_mirroring_matches_the_reference_family():
    reg = preg.MetricRegistry()
    try:
        assert prt.mirror_profiler_spans(True, reg)
        for _ in range(3):
            with pprof.RecordEvent("serving::dispatch"):
                pass
        ev = pprof.RecordEvent("user_span")
        ev.begin()
        ev.end()
    finally:
        prt.mirror_profiler_spans(False)
    child = _child(reg, "paddle_profiler_span_ms", span="serving::dispatch")
    assert child.count == 3
    assert _child(reg, "paddle_profiler_span_ms", span="user_span").count == 1
    jr = jreg.MetricRegistry()
    jr.histogram("paddle_profiler_span_ms", "", ("span",))
    assert _families(reg)["paddle_profiler_span_ms"] == \
        _families(jr)["paddle_profiler_span_ms"]
    with pprof.RecordEvent("after_detach"):
        pass
    assert _child(reg, "paddle_profiler_span_ms", span="after_detach") is None


def test_build_info_and_device_memory():
    reg = preg.MetricRegistry()
    labels = prt.install_build_info(reg)
    jr = jreg.MetricRegistry()
    jlabels = jrt.install_build_info(jr)
    pf, jf = _families(reg), _families(jr)
    assert pf["paddle_build_info"][0] == jf["paddle_build_info"][0] == \
        "gauge"
    assert labels["kernels"] == _build.library_hash() != "unknown"
    assert labels["device"] == "cpu" and labels["driver"] == "none"
    assert labels["version"] == jlabels["version"]
    assert labels["python"] == jlabels["python"]
    assert not {"jax", "jaxlib"} & set(labels)
    prt.install_build_info(reg)                   # one child, ever
    assert len(list(reg.get("paddle_build_info").collect())) == 1
    assert not prt.install_device_memory_collector(reg)


def test_telemetry_server_installs_the_collectors(fresh_monitoring):
    phttpd.stop_telemetry_server()
    prev = preg._default
    preg._default = preg.MetricRegistry()
    tflags.set_flags({"FLAGS_numerics_sample_rate": 0.0})
    try:
        srv = phttpd.start_telemetry_server(port=0, host="127.0.0.1")
        with OPENER.open(srv.url("/metrics"), timeout=10) as r:
            text = r.read().decode()
        assert "paddle_build_info{" in text
        assert "paddle_jax_events_total{" in text
        with OPENER.open(srv.url("/statusz"), timeout=10) as r:
            doc = json.loads(r.read())
        assert set(doc["numerics"]) >= {"serving", "train", "canary",
                                        "anomalies", "rates"}
        with OPENER.open(srv.url("/"), timeout=10) as r:
            assert b"/execz  /profilez  /numericsz" in r.read()
    finally:
        phttpd.stop_telemetry_server()
        preg._default = prev
