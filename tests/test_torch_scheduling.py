"""The port's multi-tenant scheduler against ``paddle_tpu``'s, with injected
clocks.

The same admission traffic, drawn from a seeded numpy generator, goes
through each package's ``TokenBucket``, ``WeightedFairQueue`` and
``AdmissionController`` (their ``SchedMetrics`` on fresh registries): the
admissions, the pick orders across tenants and priority classes, the typed
refusals and the ``/schedz`` payloads must be equal. The policy file loads
and hot-reloads the same way, untagged tenants map to ``DEFAULT_TENANT``,
and the fleet autoscaler's names work (its decisions against the
reference's are in ``test_torch_fleet_autoscaler.py``). Then an
``InferenceServer`` with ``scheduler=`` and ``telemetry_port=`` over a small
predictor answers as the reference's does, refusals included.
"""
import json
import os

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.observability import registry as jreg
from paddle_tpu.serving import scheduling as jsch
from paddle_tpu_torch import serving
from paddle_tpu_torch.observability import registry as preg
from paddle_tpu_torch.serving import scheduling as psch
from test_torch_inference import jax_predictor, mlp_pair, port_predictor

PKGS = ((psch, preg), (jsch, jreg))
ERRORS = {psch: serving.QuotaExceededError,
          jsch: jserving.QuotaExceededError}
TENANTS = ("t0", "t1", "t2", "t3", None, "", "x y", "guest")
PRIOS = ("realtime", "standard", "batch")


def _policy(sch, seed, now):
    rng = np.random.RandomState(seed)
    tenants = {}
    for i in range(4):
        name = f"t{i}"
        tenants[name] = sch.TenantPolicy(
            name, rate=float(rng.choice([0.0, 2.0, 10.0])),
            burst=float(rng.randint(2, 20)),
            weight=float(rng.choice([1.0, 2.0, 4.0])),
            priority=PRIOS[rng.randint(3)])
    return sch.SchedulerPolicy(tenants=tenants, now=now,
                               default=sch.TenantPolicy(
                                   sch.DEFAULT_TENANT, rate=5.0, burst=8.0))


class _Req:
    def __init__(self, tenant, cost):
        self.tenant, self.cost = tenant, cost


@pytest.mark.parametrize("seed", range(5))
def test_admission_and_fair_picks_match_reference(seed):
    outs = []
    for sch, reg_mod in PKGS:
        rng = np.random.RandomState(100 + seed)
        t = {"now": 0.0}
        clock = lambda: t["now"]  # noqa: E731
        metrics = sch.SchedMetrics(f"sched{seed}",
                                   registry=reg_mod.MetricRegistry())
        ctl = sch.AdmissionController(_policy(sch, seed, clock),
                                      name=f"sched{seed}", now=clock,
                                      metrics=metrics)
        log, queue = [], []
        for step in range(300):
            t["now"] += float(rng.exponential(0.05))
            tenant = TENANTS[rng.randint(len(TENANTS))]
            cost = float(rng.randint(1, 6))
            if rng.rand() < 0.6:
                try:
                    log.append(("admit", ctl.admit(tenant, cost)))
                    queue.append(_Req(tenant, cost))
                except ERRORS[sch] as e:
                    log.append(("shed", type(e).__name__, e.tenant))
            elif queue:
                idx = ctl.select(queue)
                log.append(("pick", idx, queue[idx].tenant))
                del queue[idx]
            if step % 50 == 0:
                log.append(("tokens", round(ctl.tokens_available("t1"), 6)))
        snap = ctl.snapshot()
        outs.append((log, snap))
    assert outs[0] == outs[1]
    assert any(e[0] == "shed" for e in outs[0][0])
    assert any(e[0] == "pick" for e in outs[0][0])


@pytest.mark.parametrize("seed", range(3))
def test_wfq_orders_match_reference(seed):
    orders = []
    for sch, _ in PKGS:
        rng = np.random.RandomState(seed)
        q = sch.WeightedFairQueue(_policy(sch, seed, lambda: 0.0))
        order = []
        for step in range(200):
            if rng.rand() < 0.55:
                q.push(step, str(rng.choice(["t0", "t1", "t2", "t3",
                                             "default"])),
                       cost=float(rng.randint(1, 9)))
            else:
                order.append(q.pop())
            if step % 40 == 0:
                order.append(("depths", sorted(q.depths().items()), len(q)))
        order.append(("drain", sorted(q.drain())))
        orders.append(order)
    assert orders[0] == orders[1]


def test_token_bucket_matches_reference():
    rng = np.random.RandomState(9)
    bs = [sch.TokenBucket(3.0, 5.0, now=0.0) for sch, _ in PKGS]
    unl = [sch.TokenBucket(0.0, 5.0) for sch, _ in PKGS]
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(0.2))
        n = float(rng.randint(1, 4))
        got = [b.try_acquire(n, now) for b in bs]
        assert got[0] == got[1]
        assert bs[0].available(now) == bs[1].available(now)
        assert unl[0].try_acquire(100, now) == unl[1].try_acquire(100, now)


def test_policy_file_loads_and_reloads_as_reference(tmp_path):
    path = tmp_path / "policy.json"
    doc = {"tenants": {"acme": {"rate": 200, "burst": 400, "weight": 4,
                                "priority": "realtime"},
                       "crawl": {"rate": 50, "burst": 50, "weight": 1,
                                 "priority": "batch"},
                       "bad name!": {"rate": 1}},
           "default": {"rate": 0, "burst": 64, "weight": 1,
                       "priority": "standard"}}
    path.write_text(json.dumps(doc))
    t = {"now": 0.0}
    pols = [sch.SchedulerPolicy(path=str(path), reload_interval_s=5.0,
                                now=lambda: t["now"]) for sch, _ in PKGS]
    views = []
    for p in pols:
        views.append((p.snapshot(), [p.lookup(n).as_dict() for n in
                                     ("acme", "crawl", None, "", "zzz")],
                      p.lookup("zzz").tenant))
    assert views[0] == views[1]
    for p in pols:
        p.maybe_reload()    # the first check: the file is unchanged
    doc["tenants"]["acme"]["rate"] = 7
    path.write_text(json.dumps(doc))
    os.utime(path, (1, 1))
    t["now"] = 1.0          # inside the interval: no stat, no reload
    for p in pols:
        p.maybe_reload()
    assert [p.lookup("acme").rate for p in pols] == [200.0, 200.0]
    t["now"] = 10.0
    for p in pols:
        p.maybe_reload()
    assert [p.lookup("acme").rate for p in pols] == [7.0, 7.0]
    path.write_text("{not json")
    os.utime(path, (2, 2))
    assert [p.reload() for p in pols] == [False, False]
    assert pols[0].snapshot() == pols[1].snapshot()
    assert pols[0].snapshot()["reload_errors"] == 1


def test_tenant_names_and_classes_match_reference():
    names = [None, "", "  ", "ok", " ok ", "a" * 64, "a" * 65, "x/y", 5,
             "dots.and-dashes_1"]
    for n in names:
        assert psch.normalize_tenant(n) == jsch.normalize_tenant(n)
    for p in ("realtime", "standard", "batch", "nope", None):
        assert psch.priority_rank(p) == jsch.priority_rank(p)
    assert psch.PRIORITY_CLASSES == jsch.PRIORITY_CLASSES
    assert psch.DEFAULT_TENANT == jsch.DEFAULT_TENANT == "default"
    assert psch.TenantPolicy("a", priority="bogus").priority == "standard"


def test_schedz_matches_reference():
    docs = []
    for sch, reg_mod in PKGS:
        ctls = []
        for name in ("zz_sched_b", "zz_sched_a"):
            ctl = sch.AdmissionController(
                sch.SchedulerPolicy(tenants={"t": sch.TenantPolicy(
                    "t", rate=1.0, burst=2.0)}, now=lambda: 0.0),
                name=name, now=lambda: 0.0,
                metrics=sch.SchedMetrics(name,
                                         registry=reg_mod.MetricRegistry()))
            sch.register_controller(ctl)
            for tenant in ("t", "t", "t", None):
                ctl.try_admit(tenant)
            ctls.append(ctl)
        own = sch.schedz_payload()
        own["admission"] = {k: v for k, v in own["admission"].items()
                            if k.startswith("zz_sched_")}
        own["process"] = "p"
        merged = sch.merge_schedz_payloads(own, {"r1": own})
        docs.append((own, merged))
        del ctls
    assert docs[0] == docs[1]
    assert docs[0][1]["tenants"]["t"] == {"admitted": 8, "shed_quota": 4}


def test_fleet_names_raise_naming_their_item():
    """The fleet autoscaler's names are ported now (ROADMAP item 5b part
    1): none is a stand-in, each works, and a registered autoscaler shows
    on /schedz as the reference's does."""
    for name in ("FleetAutoscaler", "AutoscaleMetrics",
                 "register_autoscaler"):
        assert not getattr(getattr(psch, name), "__not_ported__", False)

    class _Sup:
        replica_ids = [0]

        def scale_to(self, n):
            pass

    docs = []
    for sch, reg in PKGS:
        asc = sch.FleetAutoscaler(
            _Sup(), now=lambda: 5.0, name="t_sched_asc",
            metrics=sch.AutoscaleMetrics("t_sched_asc",
                                         registry=reg.MetricRegistry()))
        sch.register_autoscaler(asc)
        docs.append(sch.schedz_payload()["autoscalers"]["t_sched_asc"])
        del asc
    assert docs[0] == docs[1]
    assert docs[0]["replicas"] == 1 and docs[0]["decisions"] == []


def test_inference_server_with_scheduler_matches_reference(tmp_path):
    """InferenceServer(scheduler=, telemetry_port=0) over the MLP fixture:
    the same per-tenant quota refusals, outputs at rtol 1e-5 / atol 1e-6
    and equal snapshot keys; the server's checks leave with it."""
    from paddle_tpu.observability import httpd as jhttpd
    from paddle_tpu_torch.observability import httpd as phttpd
    jm, pm = mlp_pair()
    preds = (port_predictor(pm, str(tmp_path / "p"), [None, 8], "float32",
                            "x"),
             jax_predictor(jm, str(tmp_path / "j"), [None, 8], "float32",
                           "x"))
    rng = np.random.RandomState(0)
    reqs = [(rng.randn(rng.randint(1, 3), 8).astype("float32"),
             ("online", "offline", None)[i % 3]) for i in range(18)]
    runs = []
    prev = (phttpd.get_telemetry_server(), jhttpd.get_telemetry_server())
    for (pkg, sch, httpd), pred in zip(((serving, psch, phttpd),
                                        (jserving, jsch, jhttpd)), preds):
        pol = sch.SchedulerPolicy(tenants={
            "online": sch.TenantPolicy("online", rate=0.0,
                                       priority="realtime"),
            "offline": sch.TenantPolicy("offline", rate=1e-6, burst=5.0,
                                        priority="batch")}, now=lambda: 0.0)
        ctl = sch.AdmissionController(pol, name="ts_sched", now=lambda: 0.0)
        srv = pkg.InferenceServer(pred, max_batch_size=4, max_wait_ms=20,
                                  name="ts_sched", scheduler=ctl,
                                  telemetry_port=0, start=False)
        assert srv.telemetry is not None
        futs, refused = [], []
        for x, tenant in reqs:
            try:
                futs.append(srv.submit([x], tenant=tenant))
            except pkg.QuotaExceededError as e:
                refused.append(e.tenant)
        srv.start()
        outs = [f.result(timeout=60)[0] for f in futs]
        snap = srv.metrics.snapshot()
        assert "serving:ts_sched" in httpd.readyz()[1]["checks"]
        srv.shutdown()
        assert "serving:ts_sched" not in httpd.readyz()[1]["checks"]
        runs.append((outs, refused, snap, ctl.snapshot()["events"]))
    for i, srv_prev in enumerate(prev):
        if srv_prev is None:
            (phttpd, jhttpd)[i].stop_telemetry_server()
    (outs, refused, snap, ev), (jouts, jrefused, jsnap, jev) = runs
    assert refused == jrefused and refused and set(refused) == {"offline"}
    assert ev == jev
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o, np.asarray(jo), rtol=1e-5, atol=1e-6)

    def keys(d, pre=""):
        return sorted(pre + k for k in d) + sum(
            (keys(v, pre + k + ".") for k, v in d.items()
             if isinstance(v, dict)), [])
    assert keys(snap) == keys(jsnap)
    assert snap["counters"] == dict(jsnap["counters"])
