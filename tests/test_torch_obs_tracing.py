"""The port's request tracing against ``paddle_tpu``'s.

Trace and span ids are drawn from one counter patched into both packages,
the clock is fixed, and the same span sequences (sampled and unsampled
traces, errors, explicit promotions, a small recorder with a per-trace cap)
go through a ``SpanBuffer`` of each package: the retained spans, the drops,
the promotions, ``tracez_payload``, ``group_traces`` and the chrome events
must be equal. ``traceparent`` headers minted by one package parse in the
other, and ``sample_decision`` agrees over 1,000 trace ids at each of three
rates. Process-wide state (the process name, the exemplar table, the
sampling flag) is restored after each test.
"""
import itertools
import json
import time

import numpy as np
import pytest

from paddle_tpu.framework import flags as jflags
from paddle_tpu.observability import tracing as jtr
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.observability import tracing as ptr

BOTH = (ptr, jtr)


@pytest.fixture
def fixed_ids(monkeypatch):
    """Deterministic ids and a fixed wall clock in both packages, one
    process name; everything restored after."""
    names = [m.process_name() for m in BOTH]

    def install():
        counter = itertools.count(1)
        for m in BOTH:
            monkeypatch.setattr(m, "_gen_span_id",
                                lambda c=counter: f"{next(c):016x}")
            monkeypatch.setattr(m, "_gen_trace_id",
                                lambda c=counter: f"{next(c):032x}")
        return counter
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    for m in BOTH:
        m.set_process_name("proc-a")
        m.clear_exemplars()
    yield install
    for m, n in zip(BOTH, names):
        m.set_process_name(n)
        m.clear_exemplars()


@pytest.fixture
def sample_rate():
    """Set FLAGS_trace_sample_rate in both packages; restored after."""
    prev = (pflags.flag_value("FLAGS_trace_sample_rate"),
            jflags.flag_value("FLAGS_trace_sample_rate"))

    def set_rate(r):
        pflags.set_flags({"FLAGS_trace_sample_rate": r})
        jflags.set_flags({"FLAGS_trace_sample_rate": r})
    yield set_rate
    pflags.set_flags({"FLAGS_trace_sample_rate": prev[0]})
    jflags.set_flags({"FLAGS_trace_sample_rate": prev[1]})


def _script(m, seed):
    """One span sequence, decided by ``seed``, run through package ``m``:
    the recorder's spans and stats and each trace's state."""
    rng = np.random.RandomState(seed)
    buf = m.SpanBuffer(max_spans=40, max_per_trace=5)
    ctxs = [m.new_context(sampled=bool(rng.rand() < 0.5)) for _ in range(6)]
    t0 = 1_700_000_000_000_000_000
    for i in range(60):
        ctx = ctxs[rng.randint(len(ctxs))]
        sub = ctx.child() if rng.rand() < 0.5 else ctx
        status = "error" if rng.rand() < 0.08 else "ok"
        attrs = {"i": i, "error": "Boom"} if status == "error" else {"i": i}
        m.record_span(sub, f"s{i}", stage=("queue", "prefill",
                                           "decode_step")[i % 3],
                      start_unix_ns=t0 + i * 1_000_000 * (1 + seed),
                      duration_ms=float(rng.randint(1, 50)) / 4,
                      attrs=attrs, status=status, root=bool(i % 4 == 0),
                      buffer=buf)
        if rng.rand() < 0.05:
            m.promote(ctx, reason="deadline", buffer=buf)
    states = [(c.trace_id, c.recording, c.state.promoted,
               len(c.state.pending), c.state.dropped) for c in ctxs]
    return buf, states


@pytest.mark.parametrize("seed", range(5))
def test_flight_recorder_matches_reference(fixed_ids, seed):
    outs = []
    for m in BOTH:
        fixed_ids()
        buf, states = _script(m, seed)
        spans = buf.snapshot()
        outs.append({
            "spans": spans, "stats": buf.stats(), "states": states,
            "min_ms": buf.snapshot(min_duration_ms=5.0),
            "one": buf.snapshot(trace_id=states[0][0]),
            "groups": m.group_traces(spans, min_duration_ms=1.0, limit=3),
            "tracez": m.tracez_payload(buffer=buf, limit=4),
            "tracez_one": m.tracez_payload(buffer=buf,
                                           trace_id=states[1][0]),
            "chrome": m.chrome_trace_events(spans),
            "merged": m.merge_span_dicts(spans[:10], spans[5:15]),
        })
    assert outs[0] == outs[1]
    assert outs[0]["stats"]["dropped"] > 0 or seed % 2


def test_exemplars_and_export_match_reference(fixed_ids, tmp_path):
    outs = []
    for m in BOTH:
        fixed_ids()
        for v, tid in ((0.3, "a" * 32), (7.0, "b" * 32), (7.5, "c" * 32),
                       (99999.0, "d" * 32), (250.0, "e" * 32)):
            m.record_exemplar("paddle_serving_latency_ms", v, tid)
        m.record_exemplar("other_ms", 1.0, "f" * 32)
        buf = m.SpanBuffer(max_spans=100)
        ctx = m.new_context(sampled=True)
        m.record_span(ctx, "root", stage="request", start_unix_ns=10 ** 18,
                      duration_ms=3.0, root=True, buffer=buf)
        path = tmp_path / f"{m.__name__}.json"
        n = m.export_chrome_trace(str(path), buffer=buf)
        outs.append((m.exemplars(), m.exemplars("other_ms"), n,
                     json.loads(path.read_text()),
                     m.tracez_payload(buffer=buf)))
        m.clear_exemplars()
        assert m.exemplars() == {}
    assert outs[0] == outs[1]
    with pytest.raises(NotImplementedError, match="item 5d"):
        ptr.export_chrome_trace(str(tmp_path / "x.json"), span_dicts=[],
                                include_profiler=True)


def test_traceparent_crosses_packages(fixed_ids):
    rng = np.random.RandomState(7)
    for i in range(50):
        src, dst = BOTH if i % 2 else BOTH[::-1]
        ctx = src.TraceContext(f"{rng.randint(1, 2**62):032x}",
                               f"{rng.randint(1, 2**62):016x}",
                               sampled=bool(i % 3))
        if i % 5 == 0:
            src.promote(ctx, buffer=src.SpanBuffer())
        header = ctx.to_traceparent()
        got = dst.parse_traceparent(header)
        again = src.parse_traceparent(header)
        assert (got.trace_id, got.span_id, got.sampled) == \
            (again.trace_id, again.span_id, again.sampled) == \
            (ctx.trace_id, ctx.span_id, ctx.recording)
        assert got.to_traceparent() == header
    for bad in (None, "", 5, "00-xyz", "ff-" + "1" * 32 + "-" + "1" * 16
                + "-01", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                "00-" + "1" * 32 + "-" + "0" * 16 + "-00",
                " 00-" + "A" * 32 + "-" + "B" * 16 + "-01 "):
        assert (ptr.parse_traceparent(bad) is None) == \
            (jtr.parse_traceparent(bad) is None)


@pytest.mark.parametrize("rate", [0.01, 0.3, 0.75])
def test_sample_decision_agrees(rate):
    rng = np.random.RandomState(int(rate * 100))
    ids = ["".join(rng.choice(list("0123456789abcdef"), 32))
           for _ in range(1000)]
    got = [ptr.sample_decision(t, rate) for t in ids]
    assert got == [jtr.sample_decision(t, rate) for t in ids]
    assert 0 < sum(got) < 1000
    for edge in (0.0, 1.0, -1.0, 2.0):
        assert ptr.sample_decision(ids[0], edge) == \
            jtr.sample_decision(ids[0], edge)


def test_request_context_follows_the_sampling_flag(sample_rate):
    for rate, want in ((0.0, None), (1.0, True)):
        sample_rate(rate)
        for m in BOTH:
            ctx = m.request_context()
            assert (ctx is None) if want is None else ctx.sampled
            amb = m.new_context(sampled=False)
            with m.use_context(amb):
                assert m.request_context() is amb
                assert m.current_context() is amb
            assert m.current_context() is None


def test_start_span_nests_as_reference(fixed_ids):
    outs = []
    for m in BOTH:
        fixed_ids()
        buf = m.SpanBuffer()
        root = m.new_context(sampled=False)
        with m.start_span("outer", stage="request", ctx=root,
                          buffer=buf) as outer:
            outer.set_attr("k", 1)
            with m.start_span("inner", stage="queue", buffer=buf):
                pass
            with pytest.raises(KeyError):
                with m.start_span("fails", stage="dispatch", buffer=buf):
                    raise KeyError("x")
        with m.start_span("untraced") as s:
            assert s.ctx is None
        spans = [{k: v for k, v in s.items()
                  if k not in ("duration_ms", "start_unix_ns", "tid")}
                 for s in buf.snapshot()]
        outs.append((spans, root.state.promoted, buf.stats()))
    assert outs[0] == outs[1]
    assert outs[0][1]          # the error promoted the unsampled trace


def test_process_name_and_spans_view(fixed_ids):
    ptr.set_process_name("replica-3")
    assert ptr.process_name() == "replica-3"
    prev = ptr.set_default_buffer(ptr.SpanBuffer(max_spans=8))
    try:
        ctx = ptr.new_context(sampled=True)
        ptr.record_span(ctx, "x", stage="queue", start_unix_ns=1,
                        duration_ms=1.0)
        got = ptr.spans(ctx.trace_id)
        assert len(got) == 1 and got[0]["process"] == "replica-3"
        assert ptr.spans("0" * 32) == []
    finally:
        ptr.set_default_buffer(prev)
