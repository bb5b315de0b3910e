"""The port's telemetry endpoint against ``paddle_tpu``'s, over real HTTP on
127.0.0.1 with ephemeral ports.

Each package's ``TelemetryServer`` serves a fresh registry fed the same
operations; every endpoint must answer with the reference's status code
and JSON keys, ``/metrics`` byte for byte, and health and readiness checks
(passing, failing, raising, removed) the same way. ``/goodputz`` answers
each package's goodput ledger, driven by the same calls under one clock,
with the same document; ``/execz``, ``/profilez`` and ``/numericsz`` (the
runtime and numerics plane, once left to later work and answering 501)
answer 200 with the reference's top-level keys, and a port that cannot be
bound raises ``OSError``. Checks registered here are
removed before each test ends (the check tables are process-wide).
"""
import json
import socket
import urllib.error
import urllib.request

import pytest

from paddle_tpu.observability import httpd as jhttpd
from paddle_tpu.observability import registry as jreg
from paddle_tpu_torch.observability import httpd as phttpd
from paddle_tpu_torch.observability import registry as preg

_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
PORTED = ("/metrics", "/metrics?format=json", "/healthz", "/readyz",
          "/statusz", "/tracez", "/tracez?format=chrome", "/sloz", "/schedz",
          "/", "/nope")
UNPORTED = ("/execz", "/profilez", "/numericsz")


def _get(srv, path, accept=None):
    req = urllib.request.Request(srv.url(path))
    if accept:
        req.add_header("Accept", accept)
    try:
        with _OPENER.open(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _registry(mod):
    reg = mod.MetricRegistry()
    reg.counter("paddle_t_requests_total", "requests",
                ("code",)).labels(code="200").inc(5)
    reg.gauge("paddle_t_depth", "queue depth").set(3)
    h = reg.histogram("paddle_t_latency_ms", "latency", ("server",),
                      buckets=(1, 10, 100))
    for v in (0.5, 5, 50, 500):
        h.labels(server="s").observe(v)
    return reg


@pytest.fixture(scope="module")
def servers():
    srvs = [phttpd.TelemetryServer(port=0, host="127.0.0.1",
                                   registry=_registry(preg)).start(),
            jhttpd.TelemetryServer(port=0, host="127.0.0.1",
                                   registry=_registry(jreg)).start()]
    yield srvs
    for s in srvs:
        s.stop()


def _keys(body):
    doc = json.loads(body)
    return sorted(doc) if isinstance(doc, dict) else type(doc).__name__


@pytest.mark.parametrize("path", PORTED)
def test_endpoint_matches_reference(servers, path):
    (pc, pt, pb), (jc, jt, jb) = (_get(s, path) for s in servers)
    assert pc == jc and pt == jt
    if path == "/metrics" or path in ("/", "/nope"):
        if path == "/metrics":
            assert pb == jb
        return
    if path == "/metrics?format=json":
        assert json.loads(pb) == json.loads(jb)
    elif path == "/statusz":
        # the backend's own section differs (torch here, jax there); the
        # process fields are the reference's
        common = {"pid", "uptime_s", "python", "argv", "metric_families"}
        assert common <= set(json.loads(pb)) and common <= set(
            json.loads(jb))
        assert "torch" in json.loads(pb)
    else:
        assert _keys(pb) == _keys(jb)


def test_json_by_accept_header(servers):
    (pc, pt, pb), (jc, jt, jb) = (_get(s, "/metrics", "application/json")
                                  for s in servers)
    assert pc == jc == 200 and pt == jt == "application/json"
    assert json.loads(pb) == json.loads(jb)


@pytest.mark.parametrize("path", UNPORTED)
def test_unported_endpoints_answer_501(servers, path):
    """The three endpoints that answered 501 before the runtime and
    numerics plane was ported now answer 200 with the reference's JSON
    keys (the test keeps its name)."""
    (pc, pt, pb), (jc, jt, jb) = (_get(s, path) for s in servers)
    assert pc == jc == 200 and pt == jt == "application/json"
    assert set(json.loads(pb)) == set(json.loads(jb))


def test_goodputz_answers_the_ledger(servers):
    from paddle_tpu.observability import goodput as jgood
    from paddle_tpu_torch.observability import goodput as pgood
    clock = [0.0]
    now = lambda: clock[0]  # noqa: E731
    ledgers = [pgood.GoodputLedger(registry=preg.MetricRegistry(), now=now),
               jgood.GoodputLedger(registry=jreg.MetricRegistry(), now=now)]
    prev = [pgood.set_default_ledger(ledgers[0]),
            jgood.set_default_ledger(ledgers[1])]
    try:
        for ledger in ledgers:
            clock[0] = 10.0
            ledger.start()
            ledger.begin("step")
            clock[0] = 12.0
            ledger.record("ckpt_save", 0.5)
            ledger.end()
            ledger.arm_replay(1)
            ledger.begin("step")
            clock[0] = 13.0
            ledger.end()
        clock[0] = 14.0
        (pc, pt, pb), (jc, jt, jb) = (_get(s, "/goodputz") for s in servers)
        assert pc == jc == 200 and pt == jt == "application/json"
        pdoc, jdoc = json.loads(pb), json.loads(jb)
        assert pdoc["goodput"] == jdoc["goodput"]
        assert sorted(pdoc["steps"]) == sorted(jdoc["steps"])
        got = pdoc["goodput"]
        assert got["accounting"]["closes"] and got["elapsed_s"] == 4.0
        assert got["categories_s"] == {
            "step": 1.5, "ckpt_save": 0.5, "recovery": 1.0, "idle": 1.0,
            "compile": 0.0, "ckpt_restore": 0.0, "data_stall": 0.0}
    finally:
        pgood.set_default_ledger(prev[0])
        jgood.set_default_ledger(prev[1])


def test_health_and_readiness_match_reference(servers):
    mods = (phttpd, jhttpd)
    names = ("t_ok", "t_bad", "t_raise")
    try:
        for m in mods:
            m.add_health_check("t_ok", lambda: (True, {"q": 0}))
            m.add_readiness_check("t_ok", lambda: True)
        seen = [[_get(s, p) for p in ("/healthz", "/readyz")]
                for s in servers]
        assert [[c for c, _, _ in row] for row in seen] == [[200, 200]] * 2
        assert [json.loads(b) for _, _, b in seen[0]] == \
            [json.loads(b) for _, _, b in seen[1]]
        for m in mods:
            m.add_health_check("t_bad", lambda: (False, "worker died"))
            m.add_readiness_check("t_raise", lambda: 1 / 0)
        seen = [[_get(s, p) for p in ("/healthz", "/readyz")]
                for s in servers]
        assert [[c for c, _, _ in row] for row in seen] == [[503, 503]] * 2
        assert [json.loads(b) for _, _, b in seen[0]] == \
            [json.loads(b) for _, _, b in seen[1]]
        assert phttpd.healthz()[0] is False and phttpd.readyz()[0] is False
    finally:
        for m in mods:
            for n in names:
                m.remove_health_check(n)
                m.remove_readiness_check(n)
    for s in servers:
        assert _get(s, "/readyz")[0] == 200


def test_failed_bind_raises(servers):
    taken = servers[0].port
    with pytest.raises(OSError):
        phttpd.TelemetryServer(port=taken, host="127.0.0.1").start()
    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        with pytest.raises(OSError):
            phttpd.start_telemetry_server(port=port, host="127.0.0.1")
        assert phttpd.get_telemetry_server() is None or \
            phttpd.get_telemetry_server().port != port
    finally:
        blocker.close()


def test_shared_endpoint_lifecycle():
    prev = phttpd.get_telemetry_server()
    srv = phttpd.start_telemetry_server(port=0, host="127.0.0.1")
    try:
        assert phttpd.start_telemetry_server(port=0) is srv and srv.running
        assert _get(srv, "/healthz")[0] == 200
        with phttpd.TelemetryServer(port=0, host="127.0.0.1") as other:
            assert other.running and other.port != srv.port
        assert not other.running
    finally:
        if prev is None:
            phttpd.stop_telemetry_server()
    assert prev is not None or phttpd.get_telemetry_server() is None
