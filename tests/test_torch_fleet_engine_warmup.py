"""The generation engine's readiness surface against ``paddle_tpu``'s, on
the CPU (what a fleet worker reads before it reports ready).

The lattice ``warmup`` runs each signature once (the decode step, the
verify step under speculation, every power-of-two rows x seq bucket
prefill, chunked when the prefix cache is on): its dispatch signatures
equal the reference's ``_note_dispatch`` records, with the prefix cache on
and off and under speculation, and a second warmup finds nothing new.
``ready`` and ``mark_ready`` behave as the reference's with
``FLAGS_serving_ready_requires_warmup`` on and off. ``gpt_tiny``'s weights
are carried over from the reference.
"""
import contextlib

import pytest

from paddle_tpu.framework import flags as jflags
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.serving.generation import GenerationServer
from test_torch_flags import pin_kv_dtype  # noqa: F401
from test_torch_generation import make_pair
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


def _record_reference(srv):
    recs = []
    orig = srv._note_dispatch

    def note(site, fresh, feeds, record=True):
        recs.append((site, tuple((tuple(int(d) for d in s), str(t))
                                 for s, t in feeds)))
        return orig(site, fresh, feeds, record)

    srv._note_dispatch = note
    return recs


@pytest.mark.parametrize("variant", ["prefix", "no_prefix", "spec"])
def test_lattice_warmup_signatures_equal_reference(variant):
    jm, tm = make_pair()
    kw = {"max_batch": 4, "page_size": 8, "start": False}
    if variant == "no_prefix":
        kw["prefix_cache"] = False
    jkw, pkw = dict(kw), dict(kw)
    if variant == "spec":
        jkw.update(draft_model=jm, spec_k=2)
        pkw.update(draft_model=tm, spec_k=2)
    jsrv = JServer(jm, name="t_jwarm", **jkw)
    psrv = GenerationServer(tm, name="t_pwarm", device="cpu", **pkw)
    seqs = [8]
    try:
        recs = _record_reference(jsrv)
        jsrv.warmup(seq_buckets=seqs)
        fresh = psrv.warmup(seq_buckets=seqs)
        mine = [s for s in psrv.dispatch_signatures
                if not s[0].startswith("draft_")]
        assert mine == recs
        drafts = len(psrv.dispatch_signatures) - len(mine)
        assert fresh == len(psrv.dispatch_signatures)
        assert drafts == (len(mine) - 1 if variant == "spec" else 0)
        assert psrv.warmup(seq_buckets=seqs) == 0   # nothing new
        assert psrv.leak_check()["ok"]
    finally:
        jsrv.shutdown()
        psrv.shutdown()


@contextlib.contextmanager
def _ready_gate(on):
    name = "FLAGS_serving_ready_requires_warmup"
    old = (jflags.flag_value(name), pflags.flag_value(name))
    jflags.set_flags({name: on})
    pflags.set_flags({name: on})
    try:
        yield
    finally:
        jflags.set_flags({name: old[0]})
        pflags.set_flags({name: old[1]})


def _gate_drill(make):
    out = []
    for how in ("warmup", "mark_ready"):
        srv = make()
        out.append((srv.ready, srv._readiness()))
        if how == "warmup":
            srv.warmup(seq_buckets=[8], batch_buckets=[1])
        else:
            srv.mark_ready()
        out.append((srv.ready, srv._readiness()))
        srv.shutdown()
        out.append((srv.ready, srv._readiness()[0]))
    return out


@pytest.mark.parametrize("gate", [True, False])
def test_ready_and_mark_ready_behave_as_reference(gate):
    jm, tm = make_pair()
    with _ready_gate(gate):
        want = _gate_drill(lambda: JServer(jm, max_batch=2, page_size=8,
                                           name="t_jgate", start=False))
        got = _gate_drill(lambda: GenerationServer(
            tm, max_batch=2, page_size=8, name="t_pgate", device="cpu",
            start=False))
    assert got == want
    assert got[0][0] is (not gate) and got[1][0] is True
    assert got[2][0] is False
