"""The numerics SDC canary of the port (``observability/numerics.py``,
``serving/fleet/worker.py::arm_canary``) against ``paddle_tpu``'s, on the
CPU.

- the canary's sweep (uint32 rounds computed in int64 masked to 32 bits)
  equals the numpy golden twin and the reference's ``canary_reference()``;
- ``CanaryRunner`` fires ``on_corrupt`` once per corruption episode and
  counts runs, failures and anomalies as the reference's does;
- a stub replica corrupted with a bit flip is quarantined through the real
  router (``/readyz`` 503 ``corrupt``, breaker open), the survivor serves,
  the merged ``/numericsz`` names the corrupt replica, ``restore``
  readmits it, and the router's merged ``/execz``, ``/numericsz`` and
  ``/profilez`` answer 200 over HTTP: the reference's
  ``TestCanary::test_corrupt_replica_quarantined_and_readmitted`` run on
  both packages' classes;
- a backend without a probe gets the device sweep on its own device, and a
  corrupted device checksum (the phase's patch on the card) quarantines
  only that replica.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.framework import flags as jflags
from paddle_tpu.observability import numerics as jnum
from paddle_tpu.observability import xstats as jx
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.observability import numerics as pnum
from paddle_tpu_torch.observability import xstats as px
from paddle_tpu_torch.serving import fleet as pfleet

PORT = types.SimpleNamespace(fleet=pfleet, num=pnum, x=px, flags=tflags)
REF = types.SimpleNamespace(fleet=jfleet, num=jnum, x=jx, flags=jflags)
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def fresh_planes():
    """Fresh numerics state and signature registries in both packages (a
    registry left by an earlier test in the process would have the
    reference's merged /execz lower its programs at scrape time)."""
    for pk in (PORT, REF):
        pk.num.reset_for_tests()
        pk.x.reset_for_tests()
    yield
    for pk in (PORT, REF):
        pk.num.reset_for_tests()
        pk.x.reset_for_tests()


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _get_json(url):
    try:
        with OPENER.open(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_canary_sweep_equals_the_golden_twin_and_the_reference():
    want = jnum.canary_reference()
    assert pnum.canary_reference() == want
    assert int(pnum.canary_sweep("cpu")) == want
    a = pnum.run_device_canary(record=False, device="cpu")
    b = jnum.run_device_canary(record=False)
    assert a["ok"] and b["ok"] and a["got"] == b["got"] == want
    assert a.keys() == b.keys()


def _episodes(pk):
    fired = []
    flip = {"ok": True}
    runner = pk.num.CanaryRunner(name="t", probe=lambda: dict(flip),
                                 on_corrupt=lambda: fired.append(1))
    seen = []
    for ok in (True, False, False, True, False):
        flip["ok"] = ok
        runner.run_once()
        seen.append((runner.corrupt, len(fired)))
    doc = pk.num.numericsz_payload()
    return seen, doc["canary"]["runs"], doc["canary"]["failures"], \
        doc["anomalies"]["by_reason"]


def test_runner_fires_once_per_episode_as_the_reference():
    got, want = _episodes(PORT), _episodes(REF)
    assert got == want
    assert got[0] == [(False, 0), (True, 1), (True, 1), (False, 1),
                      (True, 2)]
    assert got[3] == {"canary_failure": 2}


def _quarantine_drill(pk):
    reps = []
    for _ in range(2):
        be = pk.fleet.StubBackend(device_ms=1.0)
        app = pk.fleet.ReplicaApp(be).start()
        be.warmup()
        pk.fleet.arm_canary(be, app, period_s=0.05)
        reps.append((be, app))
    router = pk.fleet.FleetRouter(
        {i: app.url for i, (_, app) in enumerate(reps)},
        name=f"t_canary_{pk is PORT}", health_interval_ms=50.0,
        breaker_open_ms=200.0)
    rapp = pk.fleet.RouterApp(router, host="127.0.0.1").start()
    out = {}
    try:
        assert _wait(lambda: len(router._routable()) == 2)
        # one mantissa bit: silent to sums, caught by the bit-exact probe
        reps[0][0].chaos({"corrupt": "bitflip"})

        def quarantined():
            s = {st["replica"]: st
                 for st in router.replica_states()}.get("0", {})
            return (not s.get("ready", True)
                    and s.get("breaker", {}).get("state") == "open")
        out["fenced"] = _wait(quarantined)
        code, ready = _get_json(reps[0][1].url + "/readyz")
        out["readyz"] = (code, ready.get("corrupt"))
        code, doc = _get_json(reps[0][1].url + "/numericsz")
        out["numericsz"] = (code, doc["canary"]["corrupt"],
                            doc["canary"]["last"]["probe"]["ok"])
        res = router.submit([np.ones(4, np.float32)]).result(timeout=10)
        out["served"] = bool(np.all(np.isfinite(np.asarray(res[0]))))
        merged = router.merged_numericsz()
        out["merged"] = (merged["fleet"]["corrupt_replicas"],
                         merged["fleet"]["canary_failures_total"] >= 1)
        out["http"] = {}
        for path in ("/execz", "/numericsz", "/profilez"):
            code, doc = _get_json(rapp.url(path))
            merged_n = (doc["fleet"] if "fleet" in doc
                        else doc)["replicas_merged"]
            out["http"][path] = (code, sorted(doc), merged_n)
        reps[0][0].chaos({"restore": True})
        out["readmitted"] = _wait(lambda: len(router._routable()) == 2)
    finally:
        rapp.stop()
        router.shutdown()
        for _, app in reps:
            app.stop()
    return out


def test_corrupt_replica_quarantined_and_readmitted():
    got, want = _quarantine_drill(PORT), _quarantine_drill(REF)
    assert got == want
    assert got["fenced"] and got["readmitted"] and got["served"]
    assert got["readyz"] == (503, True)
    assert got["numericsz"] == (200, True, False)
    assert got["merged"] == (["0"], True)
    assert got["http"] == {
        "/execz": (200, ["fleet", "replicas", "router"], 2),
        "/numericsz": (200, ["fleet", "replicas", "router"], 2),
        "/profilez": (200, ["captured", "replicas", "replicas_merged"], 2)}


class _DeviceBackend:
    """A backend with no probe: the canary sweeps its device."""

    device = "cpu"

    def __init__(self):
        self.marked = threading.Event()

    def ready(self):
        return True

    def mark_corrupt(self):
        self.marked.set()


def test_device_canary_quarantines_only_the_corrupted_replica(monkeypatch):
    """Two replicas sweep the CPU; the sweep of the one whose runner
    thread is named ``numerics-canary-bad`` has a bit flipped (the
    silent-data-corruption patch ``chip_smoke.py`` applies on the card):
    only that replica's runner turns corrupt and calls
    ``mark_corrupt``."""
    real = pnum.canary_sweep

    def sweep(device):
        got = real(device)
        if threading.current_thread().name == "numerics-canary-bad":
            got = got ^ 1
        return got

    monkeypatch.setattr(pnum, "canary_sweep", sweep)
    apps = {n: types.SimpleNamespace(canary=None) for n in ("good", "bad")}
    backends = {n: _DeviceBackend() for n in apps}
    runners = {n: pfleet.arm_canary(backends[n], apps[n], period_s=0.05,
                                    name=n) for n in apps}
    try:
        assert _wait(lambda: runners["bad"].corrupt)
        assert _wait(lambda: runners["good"].last is not None)
        assert backends["bad"].marked.is_set()
        assert not runners["good"].corrupt
        assert not backends["good"].marked.is_set()
        assert runners["good"].last["ok"] and "probe" not in \
            runners["good"].last
        assert runners["bad"].last["got"] == pnum.canary_reference() ^ 1
    finally:
        for r in runners.values():
            r.stop()
    assert pfleet.arm_canary(_DeviceBackend(), apps["good"],
                             period_s=0.0) is None
