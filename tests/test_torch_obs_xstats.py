"""The port's signature registry and profile ring
(``paddle_tpu_torch/observability/xstats.py``) against ``paddle_tpu``'s, on
the CPU.

- ``ExecEntry.roofline`` and ``payload`` equal the reference's for the same
  numbers; registration dedupes and merges provenance, the LRU bound
  evicts the oldest entries, the disabled flag short-circuits, and the
  peaks resolve from the flags as the reference's (the port adds the
  device's name);
- the step-profiler join sets ``paddle_mfu`` and the bandwidth gauge as
  the reference's does from the same analysis;
- every site registers at its signature's first dispatch (provenance tier
  ``eager``, measured once: later dispatches only count), and the
  ``train_step`` entry's FLOPs per token lie within 15% of ``6N + 12LHS``
  (the bench's ``_COST_AGREE_TOL``), its MFU gauge the envelope's;
- a CPU ``/profilez`` capture lists in the ring, a second one inside the
  rate limit answers 429 and a capture while another profiler session is
  active 409, where the reference answers 200 and 429 for the first two;
  an anomaly burst starts exactly one capture, and none unless armed.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.framework import flags as jflags
from paddle_tpu.observability import httpd as jhttpd
from paddle_tpu.observability import xstats as jx
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.observability import httpd as phttpd
from paddle_tpu_torch.observability import stepprof
from paddle_tpu_torch.observability import xstats as px
from paddle_tpu_torch.observability.registry import default_registry

FLAGS = ("FLAGS_xstats_enable", "FLAGS_xstats_max_entries",
         "FLAGS_device_peak_flops", "FLAGS_device_peak_bytes_per_s",
         "FLAGS_profile_dir", "FLAGS_profile_ring", "FLAGS_profile_max_ms",
         "FLAGS_profile_min_interval_s", "FLAGS_profile_on_anomaly",
         "FLAGS_profile_anomaly_ms")


def _set_both(values):
    jflags.set_flags(values)
    tflags.set_flags(values)


@pytest.fixture(autouse=True)
def fresh_xstats():
    saved = ({n: jflags.flag_value(n) for n in FLAGS},
             {n: tflags.flag_value(n) for n in FLAGS})
    jx.reset_for_tests()
    px.reset_for_tests()
    yield
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])
    jx.reset_for_tests()
    px.reset_for_tests()


def _gauge(name, **labels):
    fam = default_registry().get(name)
    for lab, child in (fam.collect() if fam is not None else []):
        if all(lab.get(k) == v for k, v in labels.items()):
            return child.value
    return None


SIG = (((8, 16), "float32"), ((16, 16), "float32"), ((8,), "int64"))


@pytest.mark.parametrize("ana", [
    {"flops": 1e9, "bytes_accessed": 1e5},
    {"flops": 1e6, "bytes_accessed": 1e5},
    {"flops": 0.0, "bytes_accessed": 0.0},
    None])
def test_entry_roofline_and_payload_equal_the_reference(ana):
    peaks = {"flops": 1e12, "bytes_per_s": 1e9, "source": "flag",
             "platform": "cpu"}
    ents = [mod.ExecEntry("generate_decode", SIG, fingerprint="f",
                          provenance={"tier": "eager"})
            for mod in (jx, px)]
    for e in ents:
        e.analysis = None if ana is None else dict(ana)
        e.created_unix_ms = 123
        e.dispatches = 2
    assert ents[1].roofline(peaks) == ents[0].roofline(peaks)
    assert ents[1].payload(peaks) == ents[0].payload(peaks)
    assert ents[1].kind == "decode"
    assert ents[1].sig_arg_bytes == 8 * 16 * 4 + 16 * 16 * 4 + 8 * 8


def test_registry_dedupes_bounds_and_short_circuits():
    for mod in (jx, px):
        a = mod.register_executable("jit", SIG, provenance={"a": 1})
        b = mod.register_executable("jit", SIG, provenance={"b": 2})
        assert a is b and a.provenance == {"a": 1, "b": 2}
    _set_both({"FLAGS_xstats_max_entries": 3})
    shapes = []
    for mod in (jx, px):
        mod.reset_for_tests()
        for i in range(5):
            mod.register_executable("jit", ((((i,), "float32"),)))
        shapes.append([e.signature[0][0]
                       for e in mod.default_exec_registry().entries()])
    assert shapes[1] == shapes[0] == [(2,), (3,), (4,)]
    px.reset_for_tests()
    _set_both({"FLAGS_xstats_enable": False})
    assert px.register_executable("jit", ()) is None
    px.on_step_envelope({"kind": "train", "wall_ms": 5.0})
    assert px.default_exec_registry().entries() == []
    calls = []
    assert px.observed_call({}, "k", "jit", lambda: calls.append(1) or 7,
                            signature_fn=lambda: ()) == 7
    assert calls == [1] and px.default_exec_registry().entries() == []


def test_device_peaks_resolve_as_the_reference():
    _set_both({"FLAGS_device_peak_flops": 1e12,
               "FLAGS_device_peak_bytes_per_s": 1e11})
    got = dict(px.device_peaks())
    assert got.pop("device") is None
    assert got == jx.device_peaks()
    _set_both({"FLAGS_device_peak_flops": 0.0,
               "FLAGS_device_peak_bytes_per_s": 0.0})
    got = dict(px.device_peaks())
    got.pop("device")
    assert got == jx.device_peaks()
    assert got["source"] == "unknown" and got["flops"] == 0.0


def test_stepprof_join_sets_the_gauges_as_the_reference():
    _set_both({"FLAGS_device_peak_flops": 1e9,
               "FLAGS_device_peak_bytes_per_s": 1e9})
    ana = {"flops": 4e6, "bytes_accessed": 2e5}
    states = []
    for mod in (jx, px):
        ent = mod.register_executable("train_step", SIG)
        ent.analysis = dict(ana)
        env = {"kind": "train", "wall_ms": 10.0}
        mod.on_step_envelope(env)
        states.append((env, mod.execz_payload(compute=False)["kinds"]))
    assert states[1] == states[0]
    assert _gauge("paddle_mfu", kind="train") == pytest.approx(0.4)
    assert _gauge("paddle_exec_bw_util", kind="train") == \
        pytest.approx(0.02)
    # record_step flows into the join
    ent = px.register_executable("generate_decode", SIG)
    ent.analysis = dict(ana)
    env = stepprof.StepProfiler(min_samples=1000).record_step(
        4.0, kind="decode")
    assert env["mfu"] == pytest.approx(1.0)


def test_train_step_entry_flops_and_mfu():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    peak = 1e12
    tflags.set_flags({"FLAGS_device_peak_flops": peak})
    prev = stepprof.set_default_profiler(
        stepprof.StepProfiler(min_samples=10_000))
    try:
        b, s = 8, 64
        cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                        num_heads=4, max_seq_len=s)
        torch.manual_seed(0)
        model = GPTForCausalLM(cfg, device="cpu")
        crit = GPTPretrainingCriterion()
        opt = AdamW(learning_rate=1e-4,
                    parameters=model.named_parameters())
        step = TrainStep(model, lambda out, y: crit(out, y), opt)
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (b, s)))
        measured = []
        real = px.measure

        def counting(call, device=None):
            measured.append(1)
            return real(call, device)

        px.measure = counting
        try:
            step(ids, ids)
            step(ids, ids)
        finally:
            px.measure = real
        assert measured == [1]
        (ent,) = [e for e in px.default_exec_registry().entries()
                  if e.site == "train_step"]
        assert ent.dispatches == 2 and ent.provenance == {"tier": "eager"}
        assert ent.signature[0] == ((0,), "tag:single")
        n = model.num_params()
        hand = 6 * n + 12 * cfg.num_layers * cfg.hidden_size * s
        per_token = ent.analysis["flops"] / (b * s)
        assert per_token == pytest.approx(hand, rel=0.15)
        assert ent.analysis["bytes_accessed"] > ent.sig_arg_bytes > 0
        env = stepprof.default_profiler().envelopes(kind="train")[-1]
        mfu = _gauge("paddle_mfu", kind="train")
        # the envelope carries the gauge rounded to 6 places; both join
        # the entry's FLOPs with the envelope's wall time
        assert env["mfu"] == pytest.approx(mfu, abs=1e-6)
        assert mfu == pytest.approx(
            ent.analysis["flops"] / (env["wall_ms"] / 1e3 * peak),
            rel=1e-9)
    finally:
        stepprof.set_default_profiler(prev)


def test_decoder_and_predictor_sites_register_once(tmp_path):
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving.generation.model_fns import CachedDecoder
    from paddle_tpu_torch.static import InputSpec
    m = GPTForCausalLM(gpt_tiny(), device="cpu").eval()
    dec = CachedDecoder(m, max_batch=2, page_size=4, pages_per_seq=4,
                        device="cpu")
    k, v = m.init_kv_pools(9, 4)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    ids = np.array([[5, 6, 7], [8, 9, 0]])
    dec.prefill(ids, np.array([3, 2], np.int32), tables, k, v)
    for i in range(3):
        dec.decode(np.array([1, 2]), np.array([3 + i, 2 + i], np.int32),
                   np.ones(2, bool), np.array([4 + i, 3 + i], np.int32),
                   tables, k, v)
    dec.prefill_chunked(ids, np.array([6, 5], np.int32),
                        np.array([3, 2], np.int32), tables, k, v)
    dec.verify(ids, np.array([9, 7], np.int32), np.array([3, 3], np.int32),
               tables, k, v)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4)).eval()
    prefix = str(tmp_path / "mlp")
    jit.save(mlp, prefix, input_spec=[InputSpec([None, 8], "float32", "x")])
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    x = np.ones((3, 8), np.float32)
    pred.run([x])
    pred.run_many([[x], [x[:1]]])
    by_site = {}
    for e in px.default_exec_registry().entries():
        by_site.setdefault(e.site, []).append(e)
    assert sorted(by_site) == ["generate_chunked", "generate_decode",
                               "generate_prefill", "generate_verify",
                               "serving"]
    assert [e.dispatches for e in by_site["generate_decode"]] == [3]
    assert sorted(e.dispatches for e in by_site["serving"]) == [1, 1]
    for site, ents in by_site.items():
        for e in ents:
            assert e.provenance == {"tier": "eager"}, site
            assert e.analysis["flops"] > 0, site
            assert e.analysis["bytes_accessed_bound"] is True
    assert by_site["serving"][0].fingerprint == pred.artifact_fingerprint()
    assert by_site["serving"][0].signature[0] == ((0,), "donate")
    doc = json.loads(phttpd.execz_text())
    assert doc["n_entries"] == 6 and doc["sites"]["generate_decode"][
        "dispatches"] == 3


def test_profilez_ring_and_rate_limit_codes(tmp_path):
    codes = []
    for mod, x, sub in ((jhttpd, jx, "j"), (phttpd, px, "p")):
        d = tmp_path / sub
        _set_both({"FLAGS_profile_dir": str(d),
                   "FLAGS_profile_min_interval_s": 30.0})
        first, body = mod.profilez_response("duration_ms=20")
        second, _ = mod.profilez_response("duration_ms=20")
        listed, ring = mod.profilez_response("")
        arts = json.loads(ring)["artifacts"]
        codes.append((first, second, listed, len(arts),
                      sorted(json.loads(body))))
    assert codes[1] == codes[0] == (200, 429, 200, 1,
                                    ["paddle_profilez", "traceEvents"])
    art = px.profilez_payload()["artifacts"][0]
    assert art["path"].endswith(".trace.json.gz") and art["bytes"] > 0
    import gzip
    with gzip.open(art["path"], "rt") as f:
        assert json.load(f)["paddle_profilez"]["reason"] == "manual"
    px.reset_for_tests()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        code, body = phttpd.profilez_response("duration_ms=20")
    assert code == 409 and json.loads(body)["type"] == "ProfilerBusyError"


def test_anomaly_burst_starts_exactly_one_capture(tmp_path):
    tflags.set_flags({"FLAGS_profile_dir": str(tmp_path),
                      "FLAGS_profile_on_anomaly": False,
                      "FLAGS_profile_anomaly_ms": 20.0,
                      "FLAGS_profile_min_interval_s": 30.0})
    px.on_anomaly({"kind": "decode"}, "ab" * 16)
    px.wait_captures()
    assert px.profilez_payload()["artifacts"] == []
    tflags.set_flags({"FLAGS_profile_on_anomaly": True})
    for _ in range(5):
        px.on_anomaly({"kind": "decode"}, "cd" * 16)
    px.wait_captures()
    arts = px.profilez_payload()["artifacts"]
    assert len(arts) == 1
    assert arts[0]["reason"] == "anomaly" and arts[0]["trace_id"] == \
        "cd" * 16
