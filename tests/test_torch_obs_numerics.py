"""The port's numerics plane (``paddle_tpu_torch/observability/numerics.py``)
against ``paddle_tpu``'s, on the CPU.

- sampling: the duty-cycle decisions under the same injected RNG, the rate
  edges and ``FLAGS_check_nan_inf`` arming every step;
- the logit statistics of seeded logits (with NaN and inf) equal the
  reference's ``_logit_stats_fn`` at rtol 1e-6;
- a note's values appear one note later in both packages;
- the same notes under injected clocks give the same ``/numericsz``
  payload and the same ``paddle_numerics_*`` samples in the Prometheus
  text (the HELP lines name each package's own maths, e.g. the reference's
  pure-JAX oracle, so they are left out);
- ``TrainStep``'s grad norm and finite fraction on ``gpt_tiny`` equal the
  reference's note at rtol 1e-5, and a NaN gradient fires exactly one
  anomaly;

The shadow checks are in ``test_torch_obs_shadow.py``, the canary and the
fleet's quarantine in ``test_torch_fleet_canary.py``.
"""
import json
import random
import re
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.observability import numerics as jnum
from paddle_tpu.observability import registry as jreg
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.observability import numerics as pnum
from paddle_tpu_torch.observability import registry as preg

FLAGS = ("FLAGS_check_nan_inf", "FLAGS_numerics_sample_rate",
         "FLAGS_numerics_shadow_rate", "FLAGS_numerics_canary_period_s",
         "FLAGS_profile_on_anomaly")


def _set_both(values):
    jflags.set_flags(values)
    tflags.set_flags(values)


@pytest.fixture(autouse=True)
def fresh_numerics():
    """Fresh numerics state in both packages; flags and RNGs restored."""
    saved = ({n: jflags.flag_value(n) for n in FLAGS},
             {n: tflags.flag_value(n) for n in FLAGS})
    jnum.reset_for_tests()
    pnum.reset_for_tests()
    yield
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])
    for mod in (jnum, pnum):
        mod.set_rng_for_tests(None)
        mod.reset_for_tests()


def test_sample_decisions_equal_the_reference():
    for rate in (0.3, 0.5, 0.9):
        jnum.set_rng_for_tests(random.Random(7))
        pnum.set_rng_for_tests(random.Random(7))
        want = [jnum.sample_decision(rate) for _ in range(64)]
        assert [pnum.sample_decision(rate) for _ in range(64)] == want
        assert any(want) and not all(want)
    pnum.set_rng_for_tests(None)
    assert not pnum.sample_decision(0.0) and pnum.sample_decision(1.0)
    _set_both({"FLAGS_check_nan_inf": True,
               "FLAGS_numerics_sample_rate": 0.25})
    assert pnum.tripwire_rate() == jnum.tripwire_rate() == 1.0
    _set_both({"FLAGS_check_nan_inf": False})
    assert pnum.tripwire_rate() == jnum.tripwire_rate() == 0.25
    assert pnum.enabled() and jnum.enabled()
    _set_both({"FLAGS_numerics_sample_rate": 0.0})
    assert not pnum.train_tripwire_armed()


def _logits(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3
    flat = x.reshape(-1)
    flat[5] = np.nan
    flat[17] = np.inf
    flat[23] = -np.inf
    # a tie for the argmax in one row: both packages take the first
    x.reshape(-1, shape[-1])[1, :2] = 50.0
    return x


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 64), (8, 1000)])
def test_logit_stats_equal_the_reference(shape):
    x = _logits(shape, seed=len(shape))
    want = np.asarray(jnum._logit_stats_fn()(x))
    got = pnum.logit_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    clean = np.nan_to_num(x, posinf=0.0, neginf=0.0)
    np.testing.assert_allclose(
        pnum.logit_stats(torch.from_numpy(clean)).numpy(),
        np.asarray(jnum._logit_stats_fn()(clean)), rtol=1e-6)


def test_values_appear_one_note_later():
    ones = np.ones((2, 8), np.float32)
    for mod, arr in ((jnum, ones), (pnum, torch.from_numpy(ones))):
        mod.note_serving_logits("decode", arr)
        assert mod._state().payload()["serving"] == {}
        mod.note_serving_logits("decode", arr)
        doc = mod._state().payload()
        assert doc["pending"] == 1
        assert doc["serving"]["decode"]["checks"] == 1
        assert mod.drain() == 1
        assert mod._state().payload()["serving"]["decode"]["checks"] == 2


def _fresh_registry(monkeypatch):
    """Fresh default registries in both packages (the numerics families
    are made again on the next note)."""
    regs = (jreg.MetricRegistry(), preg.MetricRegistry())
    monkeypatch.setattr(jreg, "_default", regs[0])
    monkeypatch.setattr(preg, "_default", regs[1])
    monkeypatch.setattr(jnum, "_metrics", None)
    monkeypatch.setattr(pnum, "_metrics", None)
    return regs


def _samples(text):
    """The paddle_numerics_* sample and TYPE lines of a Prometheus text,
    the canary's aside (see ``_scrub``)."""
    return sorted(line for line in text.splitlines()
                  if "paddle_numerics_" in line
                  and "paddle_numerics_canary_" not in line
                  and not line.startswith("# HELP"))


def _scrub(doc):
    """Trace ids are random per process: equal in form, not in value. The
    canary section is left out: a canary runner of an earlier test in this
    process (the reference's replica apps leave theirs sweeping) records
    into it from its own thread; the canary is held in
    ``test_torch_fleet_canary.py``."""
    last = doc["anomalies"]["last"]
    if last is not None:
        assert re.fullmatch(r"[0-9a-f]{32}", last["trace_id"])
        last["trace_id"] = "<id>"
    doc.pop("canary")
    return doc


def test_payloads_and_families_equal_under_injected_clocks(monkeypatch):
    from paddle_tpu.observability.exposition import prometheus_text as jtext
    from paddle_tpu_torch.observability.exposition import \
        prometheus_text as ptext
    regs = _fresh_registry(monkeypatch)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    rng = np.random.RandomState(3)
    good = rng.randn(4, 32).astype(np.float32)
    bad = good.copy()
    bad[2, 7] = np.nan
    train = [np.array([1.5, 1.0, 1.0], np.float32),
             np.array([2.5, 1.0, 1.0], np.float32),
             np.array([np.nan, 0.5, 1.0], np.float32)]
    def to_torch(a):
        return torch.from_numpy(np.asarray(a))

    for mod, wrap in ((jnum, np.asarray), (pnum, to_torch)):
        mod.note_serving_logits("decode", wrap(good))
        mod.note_serving_logits("verify", wrap(bad))
        mod.note_shadow_divergence("decode", "int8",
                                   wrap(np.float32(0.125)))
        mod.note_shadow_divergence("chunked", "f32", wrap(np.float32(0.0)))
        for i, st in enumerate(train):
            mod.note_train_step(wrap(st), loss_scale=(
                None if i == 0 else wrap(np.float32(2.0 ** (15 - i)))))
        mod.note_serving_logits("decode", wrap(good))
    docs = [_scrub(m.numericsz_payload()) for m in (jnum, pnum)]
    # as JSON: a NaN grad norm is equal to itself there
    assert json.dumps(docs[1], sort_keys=True) == \
        json.dumps(docs[0], sort_keys=True)
    assert docs[1]["anomalies"]["by_reason"] == {"nonfinite": 2}
    assert docs[1]["train"]["loss_scale"] == 2.0 ** 13
    assert _samples(ptext(regs[1])) == _samples(jtext(regs[0]))


# ------------------------------------------------------------- training
def _train_note(pkg, flag, steps=1, nan_grad=False):
    """One (or more) AdamW steps of gpt_tiny in ``pkg`` with the
    tripwires armed by ``flag``; returns the drained train section."""
    from test_torch_train import (_arrays, _ids, _jax_model, _port_model)
    _set_both({flag: 1.0 if flag.endswith("rate") else True})
    ids = _ids(1)
    jm = _jax_model()
    if pkg == "ref":
        from paddle_tpu.jit import TrainStep
        from paddle_tpu.models import GPTPretrainingCriterion
        opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                     parameters=jm.parameters())
        crit = GPTPretrainingCriterion()
        step = TrainStep(jm, lambda out, y: crit(out, y), opt)
        t = paddle.to_tensor(ids)
        for _ in range(steps):
            step(t, t)
        jnum.drain()
        return jnum.numericsz_payload()
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    m = _port_model(_arrays(jm))
    if nan_grad:
        w = dict(m.named_parameters())["gpt.embeddings.word_embeddings.weight"]
        w.register_hook(lambda g: g.index_fill(0, torch.tensor([3]),
                                               float("nan")))
    opt = AdamW(learning_rate=1e-4, parameters=m.named_parameters())
    crit = GPTPretrainingCriterion()
    step = TrainStep(m, lambda out, y: crit(out, y), opt)
    t = torch.from_numpy(ids)
    for _ in range(steps):
        step(t, t)
    pnum.drain()
    return pnum.numericsz_payload()


def test_train_step_grad_health_equals_the_reference():
    want = _train_note("ref", "FLAGS_numerics_sample_rate", steps=2)
    got = _train_note("port", "FLAGS_numerics_sample_rate", steps=2)
    for key in ("grad_norm", "grad_finite_fraction", "grad_norm_ewma",
                "grad_norm_drift"):
        np.testing.assert_allclose(got["train"][key], want["train"][key],
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert got["train"]["steps"] == want["train"]["steps"] == 2
    assert got["train"]["grad_finite_fraction"] == 1.0
    assert got["train"]["loss_finite"] and got["anomalies"]["total"] == 0


def test_train_step_nan_gradient_fires_exactly_one_anomaly():
    doc = _train_note("port", "FLAGS_check_nan_inf", nan_grad=True)
    assert doc["anomalies"]["total"] == 1
    last = doc["anomalies"]["last"]
    assert (last["kind"], last["reason"]) == ("train", "nonfinite")
    assert last["detail"]["grad_finite_fraction"] < 1.0
    assert last["detail"]["loss_finite"] is True
    assert doc["train"]["grad_finite_fraction"] < 1.0


def test_train_step_unarmed_computes_nothing():
    from test_torch_train import _arrays, _ids, _jax_model, _port_model
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    m = _port_model(_arrays(_jax_model()))
    step = TrainStep(m, lambda out, y: out.float().mean(),
                     AdamW(learning_rate=1e-4,
                           parameters=m.named_parameters()))
    t = torch.from_numpy(_ids(1))
    step(t, t)
    assert not step._numerics_armed
    assert pnum.numericsz_payload()["train"]["steps"] == 0
