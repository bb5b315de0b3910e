"""The port's fleet router, replica app and supervisor against
``paddle_tpu``'s, over stub replicas on localhost.

Each drill runs once with each package's classes (``StubBackend`` behind
``ReplicaApp`` threads, ``FleetRouter``, ``ReplicaSupervisor``) and returns
what the router accounted (its metric snapshot), the replicas' states and
the requests' outcomes; the two packages' returns must be equal. The drills:
routing and least-outstanding picks, shed and retry, a crash mid-request,
a rolling swap under concurrent traffic, hedging, deadline propagation
(router and worker side), generate streaming, cancellation and deadline
eviction, respawn and scaling under the supervisor, and the merged views.
The wedge drills are the port's alone (waited on the ``WedgeMonitor``'s
in-flight state, never on a sleep). Then across the stacks: the port's
router drives the reference's ``ReplicaApp`` and the reference's router
the port's, with the same results as within one stack.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import request as jreq
from paddle_tpu.serving.fleet import codec as jcodec
from paddle_tpu_torch.observability import tracing as ptracing
from paddle_tpu_torch.serving import fleet as pfleet
from paddle_tpu_torch.serving import request as preq
from paddle_tpu_torch.serving.fleet import codec as pcodec

PORT = types.SimpleNamespace(fleet=pfleet, codec=pcodec, req=preq,
                             tracing=ptracing, name="port")
REF = types.SimpleNamespace(fleet=jfleet, codec=jcodec, req=jreq,
                            tracing=jtracing, name="ref")
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
WAIT_S = 30.0


def _feed(v=1.0, rows=1):
    return [np.full((rows, 4), v, np.float32)]


def _wait(cond, what, timeout=WAIT_S):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"{what}: timed out"
        time.sleep(0.005)


class _Fleet:
    """Stub replicas (``ReplicaApp`` threads) of one package and a router
    over them, polled by hand; stopped on exit."""

    def __init__(self, pk, specs, name, **router_kw):
        self.pk = pk
        self.backends, self.apps = {}, {}
        for rid, kw in specs.items():
            be = pk.fleet.StubBackend(**kw)
            be.warmup()
            self.backends[rid] = be
            self.apps[rid] = pk.fleet.ReplicaApp(be).start()
        self.router = pk.fleet.FleetRouter(
            {rid: app.url for rid, app in self.apps.items()},
            name=name, start=False, **router_kw)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.router.shutdown()
        for app in self.apps.values():
            app.stop()
        return False


def _snap(router):
    s = router.metrics_snapshot()
    s.pop("request_ms")
    return s


def _rep(router, rid):
    with router._lock:
        return router._replicas[rid]


def _both(drill, **kw):
    got, want = drill(PORT, **kw), drill(REF, **kw)
    assert got == want
    return got


# ------------------------------------------------------------ routing
def _routing(pk):
    with _Fleet(pk, {"a": {"device_ms": 1.0}, "b": {"device_ms": 1.0}},
                "t_route", retry_backoff_ms_=0) as f:
        r = f.router
        outs = [r.submit(_feed(float(i))).result(WAIT_S)[0][0, 0]
                for i in range(6)]
        spread = {k: be.dispatches for k, be in f.backends.items()}
        many = [x[0][0, 0] for x in
                (fut.result(WAIT_S) for fut in
                 r.submit_many([_feed(2.0, rows=2)] * 4))]
        # least outstanding: "a" holds 5 in flight, so every pick goes
        # to "b" until they are released
        rep_a = _rep(r, "a")
        r._acquire(rep_a, 5)
        before = dict((k, be.dispatches) for k, be in f.backends.items())
        for _ in range(3):
            r.submit(_feed()).result(WAIT_S)
        after = {k: be.dispatches - before[k]
                 for k, be in f.backends.items()}
        r._release(rep_a, 5)
        states = [(s["replica"], s["ready"], s["alive"], s["outstanding"],
                   s["breaker"]["state"]) for s in r.replica_states()]
        return {"outs": [float(x) for x in outs], "spread": spread,
                "many": [float(x) for x in many], "least_outstanding":
                after, "states": states, "metrics": _snap(r)}


def test_routing_and_least_outstanding_equal_reference():
    got = _both(_routing)
    assert got["spread"] == {"a": 3, "b": 3}
    assert got["least_outstanding"] == {"a": 0, "b": 3}


def _shed(pk):
    specs = {"full": {"device_ms": 1.0, "queue_capacity": 0},
             "ok": {"device_ms": 1.0}}
    out = {}
    with _Fleet(pk, specs, "t_shed", retry_backoff_ms_=0,
                breaker_failure_ratio=1.1) as f:
        for i in range(4):
            f.router.submit(_feed(float(i))).result(WAIT_S)
        out["retry"] = _snap(f.router)
    specs["ok"] = dict(specs["full"])
    with _Fleet(pk, specs, "t_shed_all", retry_backoff_ms_=0, retries=2,
                breaker_failure_ratio=1.1) as f:
        with pytest.raises(pk.req.QueueFullError, match="3 attempts"):
            f.router.submit(_feed()).result(WAIT_S)
        out["all_full"] = _snap(f.router)
    return out


def test_shed_and_retry_accounting_equal_reference():
    got = _both(_shed)
    assert got["retry"]["retries"]["queue_full"] >= 1
    assert got["retry"]["counters"]["completed"] == 4
    assert got["all_full"]["counters"]["shed"] == 1


def _crash(pk):
    specs = {"crashy": {"device_ms": 1.0, "crash_value": 666.0,
                        "crash_mode": "drop"},
             "safe": {"device_ms": 1.0}}
    with _Fleet(pk, specs, "t_crash") as f:
        r = f.router
        r.remove_replica("safe")
        r.poll_replicas()
        with pytest.raises((pk.fleet.ReplicaError,
                            pk.req.ServerClosedError)) as ei:
            r.submit(_feed(666.0)).result(WAIT_S)
        r.add_replica("safe", f.apps["safe"].url)
        r.poll_replicas()
        ready = sorted(s["replica"] for s in r.replica_states()
                       if s["ready"])
        outs = [x.result(WAIT_S)[0][0, 0]
                for x in r.submit_many([_feed(2.0)] * 4)]
        return {"error": type(ei.value).__name__, "ready": ready,
                "outs": [float(x) for x in outs], "metrics": _snap(r)}


def test_crash_mid_request_fails_only_its_requests():
    got = _both(_crash)
    assert got["error"] == "ReplicaError" and got["ready"] == ["safe"]
    assert got["metrics"]["counters"]["failed"] == 1


def _swap(pk):
    with _Fleet(pk, {0: {"device_ms": 1.0, "version": "v1"},
                     1: {"device_ms": 1.0, "version": "v1"}},
                "t_swap") as f:
        r = f.router
        scale = {v: pk.fleet.StubBackend._scale_of(v)
                 for v in ("v1", "v2")}
        stop, failed, seen = threading.Event(), [], set()

        def traffic():
            while not stop.is_set():
                for fut in r.submit_many([_feed()] * 2):
                    try:
                        seen.add(float(fut.result(WAIT_S)[0][0, 0]))
                    except Exception as e:  # noqa: BLE001 - counted
                        failed.append(e)

        threads = [threading.Thread(target=traffic) for _ in range(2)]
        for t in threads:
            t.start()
        _wait(lambda: len(seen) >= 1, "traffic before the swap")
        report = r.swap_weights("models/v2", drain_timeout_s=10)
        after = float(r.submit(_feed()).result(WAIT_S)[0][0, 0])
        stop.set()
        for t in threads:
            t.join()
        snap = _snap(r)
        return {"failed": len(failed),
                "seen_only_versions": seen <= set(scale.values()),
                "after": after == scale["v2"],
                "versions": [x["version"] for x in report["replicas"]],
                "backends": [be.version for be in f.backends.values()],
                "swaps": snap["swaps"],
                "failed_counter": snap["counters"]["failed"]}


def test_rolling_swap_under_traffic_loses_nothing():
    got = _both(_swap)
    assert got == {"failed": 0, "seen_only_versions": True, "after": True,
                   "versions": ["v2", "v2"], "backends": ["v2", "v2"],
                   "swaps": {"replica_reloaded": 2, "completed": 1,
                             "failed": 0}, "failed_counter": 0}


def _hedge(pk):
    with _Fleet(pk, {"slow": {"device_ms": 300.0},
                     "fast": {"device_ms": 1.0}}, "t_hedge",
                breaker_failure_ratio=1.1, breaker_latency_ms=0.0,
                hedge_ms=20.0, hedge_quantile=0.5) as f:
        r = f.router
        outs = [float(r.submit(_feed(float(i))).result(WAIT_S)[0][0, 0])
                for i in range(4)]
        # the losing legs on the slow replica still complete: wasted
        _wait(lambda: r.metrics_snapshot()["hedges"]["wasted"]
              >= r.metrics_snapshot()["hedges"]["fired"], "wasted legs")
        return {"outs": outs, "metrics": _snap(r)}


def test_hedging_equal_reference():
    got = _both(_hedge)
    h = got["metrics"]["hedges"]
    # the first pick of the slow replica is hedged; its losing leg keeps
    # it the busier replica for the rest of the drill
    assert h["fired"] == h["won"] == h["wasted"] >= 1
    assert got["metrics"]["counters"]["failed"] == 0


def _deadlines(pk):
    with _Fleet(pk, {0: {"device_ms": 1.0}}, "t_ddl") as f:
        r, be, app = f.router, f.backends[0], f.apps[0]
        with pytest.raises(pk.req.DeadlineExceededError):
            r.submit(_feed(), timeout_ms=0.0001).result(WAIT_S)
        ok = float(r.submit(_feed(2.0), timeout_ms=10_000.0)
                   .result(WAIT_S)[0][0, 0])
        body = pk.codec.attach_deadline_trailer(
            pk.codec.encode_batch([_feed(), _feed(3.0)]), [-5.0, 5000.0])
        before = be.dispatches
        with OPENER.open(urllib.request.Request(
                app.url + "/submit_many", data=body), timeout=WAIT_S) as rs:
            res = pk.codec.decode_results(rs.read())
        return {"ok": ok, "worker": [type(x).__name__ if isinstance(
                    x, BaseException) else float(x[0][0, 0]) for x in res],
                "worker_dispatches": be.dispatches - before,
                "metrics": _snap(r)}


def test_deadline_propagation_equal_reference():
    got = _both(_deadlines)
    assert got["worker"][0] == "DeadlineExceededError"
    assert got["worker_dispatches"] == 1
    assert got["metrics"]["deadline_rejects"]["router"] == 1


def _generate(pk):
    with _Fleet(pk, {0: {"device_ms": 1.0, "token_ms": 2.0}},
                "t_gen") as f:
        r = f.router
        toks = r.submit_generate([5, 9], max_new_tokens=6)
        out = {"tokens": list(toks), "reason": toks.finish_reason}
        # cancel after the first two tokens: the replica's stream stops
        slow = pk.fleet.StubBackend(device_ms=1.0, token_ms=20.0)
        slow.warmup()
        app = pk.fleet.ReplicaApp(slow).start()
        r.remove_replica(0)
        r.add_replica("slow", app.url)
        r.poll_replicas()
        try:
            fut = r.submit_generate([7], max_new_tokens=500)
            it = iter(fut)
            first = [next(it), next(it)]
            assert fut.cancel()
            _wait(fut.done, "the cancelled stream")
            out["cancel"] = (first, fut.finish_reason,
                             len(fut.tokens()) < 500)
            dfut = r.submit_generate([7], max_new_tokens=500,
                                     deadline_ms=400.0)
            with pytest.raises(pk.req.DeadlineExceededError):
                dfut.result(WAIT_S)
            out["deadline"] = (dfut.finish_reason,
                               0 < len(dfut.tokens()) < 500)
            _wait(lambda: _rep(r, "slow").outstanding == 0, "release")
            out["metrics"] = _snap(r)
        finally:
            app.stop()
    return out


def test_generate_stream_cancel_and_deadline_equal_reference():
    got = _both(_generate)
    assert got["tokens"] == [10, 11, 12, 13, 14, 15]
    assert got["cancel"] == ([8, 9], "cancelled", True)
    assert got["deadline"] == ("deadline", True)


def _http_get(url):
    try:
        with OPENER.open(url, timeout=10) as rs:
            return rs.status, rs.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_wedge_drill_fails_waiters_typed():
    """A hang poison wedges the stub's device; the watchdog flips /readyz
    and the request queued behind it fails with the typed 503 "wedged".
    The drill waits on the backend's state (the poison's dispatch in
    flight on the ``WedgeMonitor``, then the waiter counted outstanding),
    never on a sleep. Port only: the reference's stub lets a waiter that
    gets the device as the hung dispatch lets it go ride the hang path
    and drop its connection (its own wedge test flakes on that race)."""
    be = pfleet.StubBackend(device_ms=1.0, hang_value=777.0)
    be.warmup()
    app = pfleet.ReplicaApp(be).start()
    wd = pfleet.arm_wedge_watchdog(be, app, timeout_ms=150.0,
                                   restart=False, name="t_wedge")
    errs = {}

    def post(tag, v):
        try:
            OPENER.open(urllib.request.Request(
                app.url + "/submit_many",
                data=pcodec.encode_batch([_feed(v)])), timeout=WAIT_S).read()
            errs[tag] = "answered"
        except urllib.error.HTTPError as e:
            errs[tag] = (e.code, b"wedged" in e.read())
        except Exception as e:  # noqa: BLE001 - the poison's drop
            errs[tag] = type(e).__name__

    try:
        poison = threading.Thread(target=post, args=("poison", 777.0))
        poison.start()
        _wait(lambda: be.wedge_monitor.inflight == 1, "poison dispatch")
        waiter = threading.Thread(target=post, args=("waiter", 1.0))
        waiter.start()
        _wait(lambda: be.info()["outstanding"] == 2 or wd.wedged,
              "the waiter queued behind the poison")
        for t in (poison, waiter):
            t.join(WAIT_S)
        code, body = _http_get(app.url + "/readyz")
        assert errs["waiter"] == (503, True)
        assert errs["poison"] == "RemoteDisconnected"
        assert (code, json.loads(body)) == (503, {"ready": False,
                                                  "version": "v0",
                                                  "wedged": True})
        assert wd.wedged and wd.wedge_count == 1
        assert be.health() == (False, "wedged")
    finally:
        wd.stop()
        app.stop()


def test_wedge_turns_into_a_supervisor_respawn():
    """restart=True: the watchdog asks the thread replica to shut down, the
    supervisor respawns it, and traffic flows again."""
    def factory(rid):
        be = pfleet.StubBackend(device_ms=1.0, hang_value=777.0)
        rep = pfleet.ThreadReplicaFactory(lambda r: be)(rid)
        pfleet.arm_wedge_watchdog(be, rep.app, timeout_ms=150.0,
                                  restart=True, name=f"t_wresp{rid}")
        return rep

    sup = pfleet.ReplicaSupervisor(factory, 1, restart_backoff_ms=10,
                                   poll_interval_s=0.01).start()
    r = pfleet.FleetRouter(supervisor=sup, name="t_wresp", start=False)
    try:
        r.poll_replicas()
        assert len(r._routable()) == 1
        with pytest.raises(pfleet.ReplicaError):
            r.submit(_feed(777.0)).result(WAIT_S)
        _wait(lambda: sup.restart_counts().get(0, 0) == 1, "respawn")
        _wait(lambda: (r.poll_replicas() or len(r._routable()) == 1),
              "ready again")
        assert float(r.submit(_feed()).result(WAIT_S)[0][0, 0]) == \
            pfleet.StubBackend._scale_of("v0")
    finally:
        r.shutdown()
        sup.stop()


def _supervised(pk):
    fac = pk.fleet.ThreadReplicaFactory(
        lambda rid: pk.fleet.StubBackend(device_ms=1.0))
    sup = pk.fleet.ReplicaSupervisor(fac, 2, restart_backoff_ms=10,
                                     poll_interval_s=0.01,
                                     name="t_sup").start()
    r = pk.fleet.FleetRouter(supervisor=sup, name="t_sup", start=False)
    try:
        r.poll_replicas()
        out = {"ready": len(r._routable())}
        fac.spawned[0].kill()
        _wait(lambda: sup.restart_counts().get(0, 0) == 1, "respawn")
        _wait(lambda: (r.poll_replicas() or len(r._routable()) == 2),
              "both ready")
        r.submit(_feed()).result(WAIT_S)
        sup.scale_to(3)
        _wait(lambda: (r.poll_replicas() or len(r._routable()) == 3),
              "scale out")
        out["ids_3"] = sup.replica_ids
        sup.scale_to(1)
        _wait(lambda: (r.poll_replicas() or len(r._routable()) == 1),
              "scale in")
        _wait(lambda: len(sup.restart_counts()) == 1, "retired slots")
        st = r.statusz()
        out.update(ids_1=sup.replica_ids, restarts=sup.restart_counts(),
                   spawned=len(fac.spawned),
                   status=(st["ready_replicas"], st["restarts_total"],
                           [x["replica"] for x in st["replicas"]]))
        return out
    finally:
        r.shutdown()
        sup.stop()


def test_supervisor_respawn_and_scaling_equal_reference():
    got = _both(_supervised)
    assert got["ready"] == 2 and got["ids_3"] == [0, 1, 2]
    assert got["ids_1"] == [0] and got["restarts"][0] == 1


def _merged(pk):
    with _Fleet(pk, {0: {"device_ms": 1.0}, 1: {"device_ms": 1.0}},
                "t_merge") as f:
        r = f.router
        ctx = pk.tracing.new_context(sampled=True)
        with pk.tracing.use_context(ctx):
            r.submit(_feed()).result(WAIT_S)
        doc = r.merged_tracez(trace_id=ctx.trace_id)
        names = sorted({s["name"] for t in doc["traces"]
                        for s in t["spans"]})
        text = r.merged_metrics()
        sloz, schedz = r.merged_sloz(), r.merged_schedz()
        return {"traces": len(doc["traces"]), "span_names": names,
                "replica_labels": sorted(
                    rid for rid in ("0", "1")
                    if f'replica="{rid}"' in text),
                "sloz_keys": sorted(sloz), "schedz_replicas":
                sorted(schedz["replicas"])}


def test_merged_views_equal_reference():
    got = _both(_merged)
    assert got["traces"] == 1
    assert {"router::request", "router::forward",
            "worker::submit_many"} <= set(got["span_names"])
    assert got["replica_labels"] == ["0", "1"]
    assert got["schedz_replicas"] == ["0", "1"]


def test_router_app_serves_the_port_views_and_501s():
    with _Fleet(PORT, {0: {"device_ms": 1.0}}, "t_app") as f:
        app = pfleet.RouterApp(f.router).start()
        try:
            body = pcodec.encode_batch([_feed(4.0)])
            with OPENER.open(urllib.request.Request(
                    app.url("/submit_many"), data=body),
                    timeout=WAIT_S) as rs:
                res = pcodec.decode_results(rs.read())
            assert float(res[0][0][0, 0]) == \
                4.0 * pfleet.StubBackend._scale_of("v0")
            for path in ("/metrics?merged=1", "/statusz", "/tracez",
                         "/sloz", "/schedz", "/readyz", "/healthz"):
                assert _http_get(app.url(path))[0] == 200, path
            # the runtime and numerics plane (501 before it was ported):
            # the router merges the replicas' answers, the worker answers
            # its own, with the reference's keys
            for path, keys in (
                    ("/execz", {"router", "replicas", "fleet"}),
                    ("/numericsz", {"router", "replicas", "fleet"}),
                    ("/profilez", {"replicas", "captured",
                                   "replicas_merged"})):
                code, text = _http_get(app.url(path))
                assert code == 200 and set(json.loads(text)) == keys, path
            for path, keys in (
                    ("/execz", {"peaks", "entries", "sites", "kinds",
                                "n_entries"}),
                    ("/numericsz", {"serving", "train", "shadow", "int8",
                                    "canary", "anomalies", "pending",
                                    "enabled", "rates"})):
                code, text = _http_get(f.apps[0].url + path)
                assert code == 200 and set(json.loads(text)) == keys, path
            # the goodput ledger is ported: the router and the worker
            # answer their process's ledger
            for url in (app.url("/goodputz"), f.apps[0].url + "/goodputz"):
                code, text = _http_get(url)
                doc = json.loads(text)
                assert code == 200, url
                assert {"goodput", "steps"} <= set(doc), url
                assert doc["goodput"]["accounting"]["closes"], url
            code, text = _http_get(f.apps[0].url + "/statusz")
            assert json.loads(text)["package"] == \
                "paddle_tpu_torch.serving.fleet"
        finally:
            app.stop()


class _Truncating:
    """A replica that answers /readyz and, on /submit_many, sends the
    headers of a 42-byte body and dies before the body."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802
                body = json.dumps({"ready": True, "version": "t"}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                self.rfile.read(int(self.headers["Content-Length"]))
                self.send_response(200)
                self.send_header("Content-Length", "42")
                self.end_headers()
                self.wfile.flush()
                self.connection.shutdown(2)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_a_truncated_response_fails_typed():
    """A replica that dies after its response began (``IncompleteRead``):
    the port's router fails those requests with ``ReplicaError``; the
    reference's lets ``http.client.IncompleteRead`` reach the caller."""
    import http.client
    fake = _Truncating()
    try:
        for pk, want in ((PORT, pfleet.ReplicaError),
                         (REF, http.client.IncompleteRead)):
            r = pk.fleet.FleetRouter({0: fake.url}, name="t_trunc",
                                     start=False)
            try:
                with pytest.raises(want):
                    r.submit(_feed()).result(WAIT_S)
                assert r.metrics_snapshot()["counters"]["failed"] == \
                    (1 if pk is PORT else 0)
            finally:
                r.shutdown()
    finally:
        fake.stop()


# ------------------------------------------------------------ cross stack
def _cross(router_pk, replica_pk):
    be = replica_pk.fleet.StubBackend(device_ms=1.0, token_ms=1.0,
                                      version="v3")
    be.warmup()
    app = replica_pk.fleet.ReplicaApp(be).start()
    r = router_pk.fleet.FleetRouter({0: app.url}, name="t_cross",
                                    start=False)
    try:
        r.poll_replicas()
        outs = [[a.tolist() for a in fut.result(WAIT_S)] for fut in
                r.submit_many([_feed(1.5, rows=2), _feed(-2.0)])]
        toks = r.submit_generate([3, 4], max_new_tokens=5)
        with pytest.raises(router_pk.req.DeadlineExceededError):
            r.submit(_feed(), timeout_ms=0.0001).result(WAIT_S)
        states = [(s["ready"], s["version"]) for s in r.replica_states()]
        return {"outs": outs, "tokens": list(toks),
                "reason": toks.finish_reason, "states": states,
                "metrics": _snap(r)}
    finally:
        r.shutdown()
        app.stop()


@pytest.mark.parametrize("router_pk,replica_pk",
                         [(PORT, REF), (REF, PORT)],
                         ids=["port_router-ref_replica",
                              "ref_router-port_replica"])
def test_cross_stack_equals_one_stack(router_pk, replica_pk):
    assert _cross(router_pk, replica_pk) == _cross(router_pk, router_pk)
