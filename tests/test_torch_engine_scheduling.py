"""The port's GenerationServer under a two-tenant scheduler against
``paddle_tpu``'s, on ``gpt_tiny`` in float32 on the CPU with the same weights.

Both engines are built with ``start=False``; the bulk wave is admitted and
decoded two steps by the same calls in both, then the realtime wave and an
untagged request are queued and the workers start, so both packages take
the same iteration-level schedule: the realtime wave finds too few free
pages and parks a bulk stream, which resumes from its full history. The
streams must match the reference's token for token, the park and resume
counts and the tenants' admission events must be equal, the over-quota
request must fail with the typed ``QuotaExceededError`` naming its tenant,
untagged requests land on ``DEFAULT_TENANT``, the leak check must be clean,
and each request's span stages must be the reference's as multisets. The
span recorder and step profiler are fresh per test and restored after.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt_tiny as j_gpt_tiny
from paddle_tpu.observability import stepprof as jsp
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.serving import QuotaExceededError as JQuota
from paddle_tpu.serving import scheduling as jsch
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import httpd as phttpd
from paddle_tpu_torch.observability import stepprof as psp
from paddle_tpu_torch.observability import tracing as ptr
from paddle_tpu_torch.serving import QuotaExceededError as PQuota
from paddle_tpu_torch.serving import scheduling as psch
from paddle_tpu_torch.serving.generation import GenerationServer
from paddle_tpu_torch.serving.generation.engine import engines_statusz
from test_torch_flags import pin_kv_dtype  # noqa: F401
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

PAGE, BATCH = 8, 4


def make_pair(seed=0):
    paddle.seed(seed)
    jm = JGPT(j_gpt_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    load_jax_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture
def fresh_recorders():
    """A fresh span recorder and step profiler in both packages."""
    prev = [(m.set_default_buffer(m.SpanBuffer(max_spans=1 << 14,
                                                max_per_trace=1024)))
            for m in (ptr, jtr)]
    profs = [m.set_default_profiler(m.StepProfiler(window=1 << 14))
             for m in (psp, jsp)]
    yield
    for m, b in zip((ptr, jtr), prev):
        m.set_default_buffer(b)
    for m, p in zip((psp, jsp), profs):
        m.set_default_profiler(p)


def _policy(sch, bulk_burst):
    return sch.SchedulerPolicy(tenants={
        "rt": sch.TenantPolicy("rt", rate=0.0, priority="realtime"),
        "bulk": sch.TenantPolicy("bulk", rate=1.0, burst=bulk_burst,
                                 priority="batch")}, now=lambda: 0.0)


def _drive(srv, steps):
    """Admit what is queued, then ``steps`` decode iterations, by the
    engine's own calls (the same in both packages)."""
    with torch.inference_mode():
        srv._admit_and_prefill()
        for _ in range(steps):
            srv._decode_iteration([s for s in srv._slots if s is not None])


def _scenario(srv, tr, quota_err, bulk, rt, dflt, bulk_new, rt_new):
    """Bulk wave (and one over-quota bulk request), two decode steps, then
    the realtime wave and an untagged request; returns the streams, the
    refusal, each request's trace id and the snapshot."""
    futs, traces = [], []

    def submit(p, n, tenant, i):
        ctx = tr.new_context(sampled=True)
        with tr.use_context(ctx):
            futs.append(srv.submit_generate(
                p, max_new_tokens=n, temperature=0.0 if i % 2 else 0.8,
                seed=i, tenant=tenant))
        traces.append(ctx.trace_id)
    for i, p in enumerate(bulk[:-1]):
        submit(p, bulk_new, "bulk", i)
    try:
        srv.submit_generate(bulk[-1], max_new_tokens=bulk_new, tenant="bulk")
        refused = None
    except quota_err as e:
        refused = (type(e).__name__, e.tenant)
    _drive(srv, 2)
    for i, p in enumerate(rt):
        submit(p, rt_new, "rt", 10 + i)
    submit(dflt, 6, None, 20)
    statusz = srv.statusz()
    srv.start()
    outs = [f.result(timeout=180) for f in futs]
    reasons = [f.finish_reason for f in futs]
    srv.shutdown()
    return outs, reasons, refused, traces, srv.metrics_snapshot(), statusz


def _stages(tr, trace_id):
    return collections.Counter(
        s["stage"] for s in tr.default_buffer().snapshot(trace_id=trace_id))


# (bulk prompt, bulk new, rt prompt, rt new, spare pages). In these the
# parked streams' prompt pages are gone when they resume (a cold prefill):
# where a resume matches cached pages, the reference engine evicts them for
# the resume's own reservation and maps a page twice (test below)
CASES = {
    "one_parked": (24, 16, 12, 8, 2),
    "three_parked": (24, 16, 24, 16, 1),
    "two_parked": (32, 16, 24, 16, 2),
}
# resumes that reuse their cached prompt pages
PREFIX_CASES = {"one_parked": (40, 16, 12, 8, 1),
                "two_parked": (40, 16, 16, 16, 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_streams_and_parking_match_reference(fresh_recorders, case):
    bp, bn, rp, rn, spare = CASES[case]
    jm, tm = make_pair()
    rng = np.random.RandomState(5)
    bulk = [rng.randint(1, 256, bp).tolist() for _ in range(4)]
    rt = [rng.randint(1, 256, rp).tolist() for _ in range(2)]
    dflt = rng.randint(1, 256, 10).tolist()
    per_bulk = -(-(bp + bn) // PAGE)
    num_pages = 1 + 3 * per_bulk + spare
    burst = 3 * (bp + bn)            # room for three bulk requests
    runs = []
    for Server, sch, tr, err, model, extra in (
            (GenerationServer, psch, ptr, PQuota, tm, {"device": "cpu"}),
            (JServer, jsch, jtr, JQuota, jm, {})):
        ctl = sch.AdmissionController(_policy(sch, burst), name=f"es_{case}",
                                      now=lambda: 0.0)
        srv = Server(model, max_batch=BATCH, page_size=PAGE,
                     num_pages=num_pages, scheduler=ctl, name=f"es_{case}",
                     start=False, **extra)
        outs, reasons, refused, traces, snap, statusz = _scenario(
            srv, tr, err, bulk, rt, dflt, bn, rn)
        stages = [_stages(tr, t) for t in traces]
        runs.append((outs, reasons, refused, snap, statusz,
                     ctl.snapshot()["events"], stages,
                     srv.kv.leak_check()))
    (outs, reasons, refused, snap, statusz, events, stages, leak), \
        (jouts, jreasons, jrefused, jsnap, jstatusz, jevents, jstages,
         jleak) = runs
    assert outs == jouts
    assert reasons == jreasons == ["length"] * len(outs)
    assert [len(o) for o in outs] == [bn] * 3 + [rn] * 2 + [6]
    assert refused == jrefused == ("QuotaExceededError", "bulk")
    c = snap["counters"]
    for key in ("parked", "resumed", "preempted", "rejected", "completed"):
        assert c[key] == jsnap["counters"][key], key
    assert c["parked"] >= 1 and c["resumed"] == c["parked"]
    assert events == jevents
    assert events["default"] == {"admitted": 1}
    assert statusz["tenant_queue_depth"] == \
        jstatusz["tenant_queue_depth"] == {"rt": 2, "default": 1}
    assert leak["ok"] and jleak["ok"]
    assert stages == jstages
    assert all({"queue", "prefill", "decode_step", "request"} <= set(s)
               for s in stages)
    # a parked stream queued and prefilled twice
    assert any(s["queue"] == 2 and s["prefill"] == 2 for s in stages)
    # the step profiler's decode envelopes count the engine's steps
    for m, sn in ((psp, snap), (jsp, jsnap)):
        kinds = m.default_profiler().summary()["kinds"]
        assert kinds["decode"]["samples"] == sn["step_ms"]["decode"]["count"]


@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_prefix_resume_streams_as_if_never_parked(fresh_recorders, case):
    """A parked stream that resumes over its cached prompt pages (chunked
    prefill) streams token for token what the reference engine streams
    with no scheduler and pages for every request (nothing parked), on the
    same future and RNG; no page is mapped twice in a block table."""
    bp, bn, rp, rn, spare = PREFIX_CASES[case]
    jm, tm = make_pair()
    rng = np.random.RandomState(5)
    bulk = [rng.randint(1, 256, bp).tolist() for _ in range(4)]
    rt = [rng.randint(1, 256, rp).tolist() for _ in range(2)]
    dflt = rng.randint(1, 256, 10).tolist()
    ctl = psch.AdmissionController(_policy(psch, 3 * (bp + bn)),
                                   name=f"es_px_{case}", now=lambda: 0.0)
    srv = GenerationServer(tm, max_batch=BATCH, page_size=PAGE,
                           num_pages=1 + 3 * -(-(bp + bn) // PAGE) + spare,
                           scheduler=ctl, name=f"es_px_{case}",
                           device="cpu", start=False)
    doubled = []
    admit = srv._admit_and_prefill

    def checked():
        admit()
        doubled.extend(list(s.pages) for s in srv._slots
                       if s is not None and len(set(s.pages)) < len(s.pages))
    srv._admit_and_prefill = checked
    outs, reasons, refused, _, snap, _ = _scenario(
        srv, ptr, PQuota, bulk, rt, dflt, bn, rn)
    ref = JServer(jm, max_batch=8, page_size=PAGE, name=f"es_px_ref_{case}",
                  start=False)
    reqs = [(p, bn, i) for i, p in enumerate(bulk[:-1])] + \
        [(p, rn, 10 + i) for i, p in enumerate(rt)] + [(dflt, 6, 20)]
    futs = [ref.submit_generate(p, max_new_tokens=n, seed=i,
                                temperature=0.0 if i % 2 else 0.8)
            for p, n, i in reqs]
    ref.start()
    want = [f.result(timeout=180) for f in futs]
    ref.shutdown()
    assert outs == want and reasons == ["length"] * len(outs)
    assert refused == ("QuotaExceededError", "bulk")
    assert snap["counters"]["parked"] >= 1 and snap["prefix"]["hits"] >= 1
    assert srv.decoder.calls["chunked"] >= 1 and doubled == []
    assert srv.kv.leak_check()["ok"]


def test_parked_prompt_pages_stay_pinned(fresh_recorders):
    """A resumed stream whose cached prompt pages the pool would evict for
    its own reservation keeps them: no page twice in a block table (the
    reference engine maps the evicted page again), the leak check clean."""
    _, tm = make_pair()
    rng = np.random.RandomState(5)
    bulk = [rng.randint(1, 256, 64).tolist() for _ in range(3)]
    rt = [rng.randint(1, 256, 16).tolist() for _ in range(3)]
    ctl = psch.AdmissionController(_policy(psch, 1e9), name="es_pin",
                                   now=lambda: 0.0)
    srv = GenerationServer(tm, max_batch=BATCH, page_size=PAGE,
                           num_pages=33, scheduler=ctl, name="es_pin",
                           device="cpu", start=False)
    doubled = []
    admit = srv._admit_and_prefill

    def checked():
        admit()
        doubled.extend(list(s.pages) for s in srv._slots
                       if s is not None and len(set(s.pages)) < len(s.pages))
    srv._admit_and_prefill = checked
    futs = [srv.submit_generate(p, max_new_tokens=16, tenant="bulk")
            for p in bulk]
    _drive(srv, 2)
    futs += [srv.submit_generate(p, max_new_tokens=8, tenant="rt")
             for p in rt]
    srv.start()
    outs = [f.result(timeout=180) for f in futs]
    srv.shutdown()
    snap = srv.metrics_snapshot()
    assert doubled == []
    assert [len(o) for o in outs] == [16] * 3 + [8] * 3
    assert snap["counters"]["parked"] >= 1 and snap["prefix"]["hits"] >= 1
    assert srv.kv.leak_check()["ok"]


def test_preempted_stream_fails_typed_when_it_cannot_resume():
    """A parked stream that cannot be re-queued (the engine is closing)
    fails with QuotaExceededError naming its tenant, as the reference's."""
    errs = []
    jm, tm = make_pair()
    for Server, sch, model, extra in (
            (GenerationServer, psch, tm, {"device": "cpu"}),
            (JServer, jsch, jm, {})):
        ctl = sch.AdmissionController(_policy(sch, 1e9), name="es_pre",
                                      now=lambda: 0.0)
        srv = Server(model, max_batch=2, page_size=PAGE, num_pages=8,
                     scheduler=ctl, name="es_pre", start=False, **extra)
        f = srv.submit_generate(list(range(1, 25)), max_new_tokens=16,
                                tenant="bulk")
        _drive(srv, 1)
        with srv._lock:
            srv._closed = True
            victim = next(s for s in srv._slots if s is not None)
            srv._park(victim)
        srv._closed = False
        srv.shutdown()
        errs.append((type(f.exception()).__name__, f.exception().tenant,
                     f.finish_reason, srv.metrics_snapshot()["counters"]
                     ["preempted"], srv.kv.leak_check()["ok"]))
    assert errs[0] == errs[1] == ("QuotaExceededError", "bulk", "preempted",
                                  1, True)


def test_engine_telemetry_checks_and_statusz():
    """telemetry_port=0 attaches the shared endpoint with the engine's
    decode:<name> checks; /readyz's check fails once the engine closes and
    leaves with shutdown; engines_statusz carries the tenant depths."""
    _, tm = make_pair()
    prev = phttpd.get_telemetry_server()
    ctl = psch.AdmissionController(_policy(psch, 1e9), name="es_tel")
    srv = GenerationServer(tm, max_batch=2, page_size=PAGE, device="cpu",
                           telemetry_port=0, scheduler=ctl, name="es_tel",
                           start=False)
    try:
        assert srv.telemetry is not None and srv.telemetry.port > 0
        assert phttpd.healthz()[1]["checks"]["decode:es_tel"]["ok"]
        assert phttpd.readyz()[1]["checks"]["decode:es_tel"]["ok"]
        f = srv.submit_generate([1, 2, 3], max_new_tokens=4, tenant="rt")
        section = engines_statusz()["es_tel"]
        assert section["tenant_queue_depth"] == {"rt": 1}
        assert section["queue_depth"] == 1 and section["kv_leak_check"]["ok"]
        srv._closed = True
        assert not phttpd.readyz()[1]["checks"]["decode:es_tel"]["ok"]
        assert not phttpd.healthz()[0]
        srv._closed = False
        srv.start()
        assert len(f.result(timeout=60)) == 4
    finally:
        srv.shutdown()
        if prev is None:
            phttpd.stop_telemetry_server()
    assert "decode:es_tel" not in phttpd.readyz()[1]["checks"]
    assert "decode:es_tel" not in phttpd.healthz()[1]["checks"]
