"""The compile cache at the port's three dispatch sites, on the CPU: the
``Predictor`` (site ``serving``), ``CachedDecoder`` (``generate_*``) and
``TrainStep`` (``train_step``).

For each: a first object on an empty directory misses and stores its
first-dispatch record; a fresh object on the warm directory has 0 misses
and hits; its outputs are bit for bit those of an object without the
cache; the stored record equals a fresh measurement of the same signature
(FLOPs, bytes and, on the card only, memory: the CPU has no allocator
readings); the xstats provenance reads ``{"cache": "miss"|"hit", "tier":
"record"}``, the ``paddle_compile_cache_*`` families count by site, and
goodput ``compile`` seconds grow on misses only. One temporary directory
per test.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import compile_cache as cc
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.observability import default_registry, goodput
from paddle_tpu_torch.observability import xstats as px

RECORD_KEYS = ("flops", "kernel_flops", "bytes_accessed",
               "bytes_accessed_bound", "transcendentals", "source")


@pytest.fixture
def cache_dir(tmp_path):
    px.reset_for_tests()
    prev = goodput.set_default_ledger(goodput.GoodputLedger())
    d = str(tmp_path / "cc")
    pflags.set_flags({"FLAGS_compile_cache_dir": d})
    cc.reset_default_cache()
    try:
        yield d
    finally:
        pflags.set_flags({"FLAGS_compile_cache_dir": ""})
        cc.reset_default_cache()
        goodput.set_default_ledger(prev)
        px.reset_for_tests()


def _counts(site):
    reg = default_registry()
    return tuple(int(reg.counter(f"paddle_compile_cache_{k}_total",
                                 labelnames=("site",)).labels(site=site)
                     .value) for k in ("hits", "misses"))


def _compile_s():
    return goodput.default_ledger().report()["categories_s"]["compile"]


def _entries(site):
    return [e for e in px.default_exec_registry().entries()
            if e.site == site]


def _stored(directory):
    store = cc.CacheStore(directory)
    return [store.get(k)["payload"] for k, _, _ in store.entries()]


def _same_record(record, analysis):
    assert {k: record.get(k) for k in RECORD_KEYS} == \
        {k: analysis.get(k) for k in RECORD_KEYS}
    assert record["flops"] > 0 and record["bytes_accessed"] > 0


def _cache_off():
    pflags.set_flags({"FLAGS_compile_cache_dir": ""})


def _cache_on(d):
    pflags.set_flags({"FLAGS_compile_cache_dir": d})


def test_predictor_site(cache_dir, tmp_path):
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec
    torch.manual_seed(0)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4)).eval()
    prefix = str(tmp_path / "mlp")
    jit.save(mlp, prefix, input_spec=[InputSpec([None, 8], "float32", "x")])

    def predictor():
        cfg = inference.Config(prefix)
        cfg.disable_gpu()
        return inference.create_predictor(cfg)

    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    h0, m0 = _counts("serving")
    c0 = _compile_s()
    cold = predictor()
    out_cold = cold.run([x])[0]
    assert cold.cache_outcomes["serving"] == "miss"
    assert _counts("serving") == (h0, m0 + 1)
    c1 = _compile_s()
    assert c1 > c0
    (ent,) = _entries("serving")
    assert ent.provenance == {"cache": "miss", "tier": "record"}
    (rec,) = _stored(cache_dir)
    _same_record(rec, ent.analysis)
    # a fresh Predictor on the warm directory: a hit, nothing measured
    px.reset_for_tests()
    measured = []
    real = px.measure
    px.measure = lambda call, device=None: (measured.append(1),
                                            real(call, device))[1]
    try:
        warm = predictor()
        out_warm = warm.run([x])[0]
        warm.run([x])
    finally:
        px.measure = real
    assert measured == [] and warm.cache_outcomes["serving"] is None
    assert _counts("serving") == (h0 + 1, m0 + 1)
    assert _compile_s() == c1
    (ent,) = _entries("serving")
    assert ent.provenance == {"cache": "hit", "tier": "record"}
    assert ent.dispatches == 2
    assert ent.fingerprint == warm.artifact_fingerprint()
    _same_record(rec, ent.analysis)
    # bit for bit the uncached Predictor's, whose fresh measurement is the
    # stored record
    px.reset_for_tests()
    _cache_off()
    plain = predictor()
    out_plain = plain.run([x])[0]
    _cache_on(cache_dir)
    assert np.array_equal(out_warm, out_cold)
    assert np.array_equal(out_warm, out_plain)
    (ent,) = _entries("serving")
    assert ent.provenance == {"tier": "eager"}
    _same_record(rec, ent.analysis)
    # another batch signature misses; a compile-relevant flag makes the
    # stored one miss too
    other = predictor()
    other.run([x[:1]])
    assert _counts("serving") == (h0 + 1, m0 + 2)
    pflags.set_flags({"FLAGS_serving_donate_inputs": False})
    try:
        predictor().run([x])
    finally:
        pflags.set_flags({"FLAGS_serving_donate_inputs": True})
    assert _counts("serving") == (h0 + 1, m0 + 3)


def _decode_calls(dec, m):
    k, v = m.init_kv_pools(9, 4)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    ids = np.array([[5, 6, 7], [8, 9, 0]])
    outs = [dec.prefill(ids, np.array([3, 2], np.int32), tables, k, v)[0]]
    for i in range(2):
        outs.append(dec.decode(
            np.array([1, 2]), np.array([3 + i, 2 + i], np.int32),
            np.ones(2, bool), np.array([4 + i, 3 + i], np.int32),
            tables, k, v)[0])
    outs.append(dec.prefill_chunked(ids, np.array([5, 4], np.int32),
                                    np.array([3, 2], np.int32), tables,
                                    k, v)[0])
    outs.append(dec.verify(ids, np.array([8, 6], np.int32),
                           np.array([3, 3], np.int32), tables, k, v)[0])
    return [o.clone() for o in outs] + [torch.stack(list(k)).clone(),
                                        torch.stack(list(v)).clone()]


SITES = ("generate_prefill", "generate_decode", "generate_chunked",
         "generate_verify")


def test_cached_decoder_site(cache_dir):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder

    def decoder(seed=0, **kw):
        m = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed).eval()
        geom = dict(dict(max_batch=2, page_size=4, pages_per_seq=4), **kw)
        return CachedDecoder(m, device="cpu", **geom), m

    before = {s: _counts(s) for s in SITES}
    dec, m = decoder()
    cold = _decode_calls(dec, m)
    assert {s: _counts(s)[1] - before[s][1] for s in SITES} == \
        dict.fromkeys(SITES, 1)
    measured = {e.site: e.analysis for e in px.default_exec_registry()
                .entries()}
    assert all(e.provenance == {"cache": "miss", "tier": "record"}
               for e in px.default_exec_registry().entries())
    stored = _stored(cache_dir)
    assert len(stored) == 4
    # the fingerprint: the model's layout and the decode geometry
    dec2, m2 = decoder(seed=1)
    assert dec2.fingerprint() == dec.fingerprint()
    assert decoder(max_batch=4)[0].fingerprint() != dec.fingerprint()
    assert decoder(use_kernels=False)[0].fingerprint() != dec.fingerprint()
    # a fresh decoder of the same weights on the warm directory
    px.reset_for_tests()
    warm_dec, wm = decoder()
    warm = _decode_calls(warm_dec, wm)
    assert {s: _counts(s) for s in SITES} == {
        s: (before[s][0] + 1, before[s][1] + 1) for s in SITES}
    for e in px.default_exec_registry().entries():
        assert e.provenance == {"cache": "hit", "tier": "record"}, e.site
        _same_record(e.analysis, measured[e.site])
    px.reset_for_tests()
    _cache_off()
    plain_dec, pm = decoder()
    plain = _decode_calls(plain_dec, pm)
    _cache_on(cache_dir)
    for a, b, c in zip(cold, warm, plain):
        assert torch.equal(a, b) and torch.equal(b, c)
    for e in px.default_exec_registry().entries():
        _same_record(measured[e.site], e.analysis)


def _train_parts(seed=0):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    return model, TrainStep(model, lambda out, y: crit(out, y), opt)


def _steps(step, model, ids):
    losses = [step(ids, ids).clone() for _ in range(2)]
    return losses + [p.detach().clone() for p in model.parameters()]


def test_train_step_site(cache_dir):
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 16)))
    h0, m0 = _counts("train_step")
    c0 = _compile_s()
    model, step = _train_parts()
    cold = _steps(step, model, ids)
    assert _counts("train_step") == (h0, m0 + 1)
    c1 = _compile_s()
    assert c1 > c0
    (ent,) = _entries("train_step")
    assert ent.provenance == {"cache": "miss", "tier": "record"}
    assert ent.dispatches == 2
    measured = dict(ent.analysis)
    (rec,) = _stored(cache_dir)
    _same_record(rec, measured)
    # a fresh TrainStep over a fresh model and optimizer: a hit
    px.reset_for_tests()
    model, step = _train_parts()
    warm = _steps(step, model, ids)
    assert _counts("train_step") == (h0 + 1, m0 + 1)
    assert _compile_s() == c1
    (ent,) = _entries("train_step")
    assert ent.provenance == {"cache": "hit", "tier": "record"}
    _same_record(ent.analysis, measured)
    px.reset_for_tests()
    _cache_off()
    model, step = _train_parts()
    plain = _steps(step, model, ids)
    _cache_on(cache_dir)
    for a, b, c in zip(cold, warm, plain):
        assert torch.equal(a, b) and torch.equal(b, c)
    (ent,) = _entries("train_step")
    _same_record(rec, ent.analysis)
    # the step's identity: another loss function, another AMP level and
    # another optimizer setting each miss
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    for variant in ("loss", "amp", "decay"):
        model, step = _train_parts()
        opt = step.optimizer
        if variant == "decay":
            opt = AdamW(learning_rate=1e-3, weight_decay=0.1,
                        parameters=model.named_parameters())
        loss = (lambda out, y: out.float().mean()) if variant == "loss" \
            else step.loss_fn
        TrainStep(model, loss, opt,
                  amp_level="O1" if variant == "amp" else None)(ids, ids)
    assert _counts("train_step") == (h0 + 1, m0 + 4)


def test_a_failing_dispatch_runs_once_and_raises(cache_dir):
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("device fault")

    with pytest.raises(RuntimeError, match="device fault"):
        px.observed_call({}, "k", "serving", boom,
                         signature_fn=lambda: (((1,), "float32"),),
                         identity=lambda: "ident")
    assert calls == [1] and _stored(cache_dir) == []
    # no identity: the uncached path
    out = px.observed_call({}, "k", "serving", lambda: 7,
                           signature_fn=lambda: (((2,), "float32"),),
                           identity=lambda: None)
    assert out == 7 and _entries("serving")[0].provenance == {
        "tier": "eager"}
