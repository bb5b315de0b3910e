"""Real models through the port's fleet against ``paddle_tpu``'s, on the
CPU.

- The MLP of ``tests/test_serving.py`` and ``ernie_tiny``'s classifier
  (bert_tiny's size), each saved by its own package's ``jit.save`` from
  the same weights (carried by ``convert.py``), served by two thread
  replicas of each package's fleet (``PredictorBackend`` behind
  ``ReplicaApp``, a ``ReplicaSupervisor`` and a ``FleetRouter``): every
  response within rtol 1e-5 / atol 1e-6 of the reference's
  ``Predictor.run`` on that request, before and after a rolling
  ``swap_weights`` to a second version of the weights; the version stamps
  are ``<basename>@<fingerprint[:8]>`` and the fingerprint is stable across
  loads.
- ``gpt_tiny`` (weights carried over) streams greedily through the port
  router's ``submit_generate`` over two thread replicas that share the
  model, token for token the reference engine's on each prompt alone.
- A bf16 ERNIE ``Predictor`` (``amp.decorate``, then ``jit.save``) through
  a fleet: its outputs cross the wire as ``ml_dtypes`` bfloat16, bit for
  bit ``Predictor.run``'s.
"""
import contextlib
import time

import ml_dtypes
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu_torch import amp, convert
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.serving import fleet as pfleet
from paddle_tpu_torch.serving.generation import GenerationServer
from test_torch_flags import pin_kv_dtype  # noqa: F401
from test_torch_generation import make_pair
from test_torch_inference import (MLP_ATOL, MLP_RTOL, _arrays, ernie_pair,
                                  jax_predictor, port_predictor)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

WAIT_S = 60.0


def _mlp(seed):
    """The MLP fixture's architecture at ``seed``, in both packages."""
    import torch
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(),
                        jnn.Linear(16, 4)).eval()
    pm = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                             torch.nn.Linear(16, 4)).eval()
    return jm, convert.load_jax_state(pm, _arrays(jm))


@contextlib.contextmanager
def _fleet(pkg, factory, n=2, name="t_pf"):
    sup = pkg.ReplicaSupervisor(pkg.ThreadReplicaFactory(factory), n,
                                name=name).start()
    router = pkg.FleetRouter(supervisor=sup, name=name, start=False)
    try:
        assert router.wait_ready(n, timeout=WAIT_S)
        yield router, sup
    finally:
        router.shutdown()
        sup.stop()


def _serve(router, reqs):
    return [f.result(WAIT_S)[0] for f in router.submit_many([[r]
                                                             for r in reqs])]


def _close(outs, reqs, ref_pred):
    for o, r in zip(outs, reqs):
        np.testing.assert_allclose(o, ref_pred.run([r])[0], rtol=MLP_RTOL,
                                   atol=MLP_ATOL)


def _versions(router):
    router.poll_replicas()      # the version stamps ride /readyz
    return sorted(s["version"] for s in router.replica_states())


def test_mlp_fleets_match_reference_predictor_across_a_swap(tmp_path):
    preds = {}
    for v, seed in (("v1", 0), ("v2", 1)):
        jm, pm = _mlp(seed)
        port_predictor(pm, str(tmp_path / f"p_{v}"), [None, 8], "float32",
                       "x")
        preds[v] = jax_predictor(jm, str(tmp_path / f"j_{v}"), [None, 8],
                                 "float32", "x")
    rng = np.random.RandomState(3)
    reqs = [rng.randn(int(rng.randint(1, 4)), 8).astype(np.float32)
            for _ in range(12)]
    fleets = (
        (pfleet, lambda rid: pfleet.PredictorBackend(
            str(tmp_path / "p_v1"), max_batch_size=4, device="cpu",
            name=f"t_pf{rid}"), "p_"),
        (jfleet, lambda rid: jfleet.PredictorBackend(
            str(tmp_path / "j_v1"), max_batch_size=4,
            name=f"t_jf{rid}"), "j_"))
    stamps = {}
    for pkg, factory, pre in fleets:
        with _fleet(pkg, factory) as (router, _):
            _close(_serve(router, reqs), reqs, preds["v1"])
            before = _versions(router)
            report = router.swap_weights(str(tmp_path / f"{pre}v2"))
            assert [r["version"].split("@")[0] for r in report["replicas"]] \
                == [f"{pre}v2"] * 2
            _close(_serve(router, reqs), reqs, preds["v2"])
            stamps[pre] = (before, _versions(router))
    before, after = stamps["p_"]
    assert all(s.startswith("p_v1@") for s in before)
    assert all(s.startswith("p_v2@") for s in after)
    # the same program and weight layout: one fingerprint for both versions
    assert len({s.split("@")[1] for s in before + after}) == 1


def test_fingerprint_is_stable_across_loads(tmp_path):
    _, pm = _mlp(0)
    fps = [port_predictor(pm, str(tmp_path / "m"), [None, 8], "float32",
                          "x").artifact_fingerprint()]
    from paddle_tpu_torch import inference
    for _ in range(2):
        cfg = inference.Config(str(tmp_path / "m"))
        cfg.disable_gpu()
        fps.append(inference.create_predictor(cfg).artifact_fingerprint())
    assert len(set(fps)) == 1 and len(fps[0]) == 64
    be = pfleet.PredictorBackend(str(tmp_path / "m"), device="cpu",
                                 warmup_mode="none", name="t_fp")
    try:
        assert be.info()["version"] == f"m@{fps[0][:8]}"
        assert not be.ready()
        assert be.warmup() == 0 and be.ready()
    finally:
        be.shutdown()


def test_ernie_fleets_match_reference_predictor(tmp_path):
    jm, pm = ernie_pair()
    port_predictor(pm, str(tmp_path / "p"), [None, None], "int64", "ids")
    jp = jax_predictor(jm, str(tmp_path / "j"), [1, 32], "int64", "ids")
    rng = np.random.RandomState(5)
    reqs = [rng.randint(1, 256, (1, 32)).astype(np.int64) for _ in range(8)]
    # the reference's export takes no dynamic axis: one row a batch there
    fleets = ((pfleet, lambda rid: pfleet.PredictorBackend(
                  str(tmp_path / "p"), max_batch_size=4, device="cpu",
                  name=f"t_pe{rid}")),
              (jfleet, lambda rid: jfleet.PredictorBackend(
                  str(tmp_path / "j"), max_batch_size=1,
                  name=f"t_je{rid}")))
    for pkg, factory in fleets:
        with _fleet(pkg, factory, name="t_pe") as (router, _):
            _close(_serve(router, reqs), reqs, jp)


def test_bf16_predictor_crosses_the_fleet_as_bfloat16(tmp_path):
    _, pm = ernie_pair()
    amp.decorate(pm, dtype="bfloat16")
    pp = port_predictor(pm, str(tmp_path / "b"), [None, None], "int64",
                        "ids")
    rng = np.random.RandomState(6)
    reqs = [rng.randint(1, 256, (1, int(n))).astype(np.int64)
            for n in rng.randint(4, 20, 6)]
    with _fleet(pfleet, lambda rid: pfleet.PredictorBackend(
            str(tmp_path / "b"), max_batch_size=1, device="cpu",
            name=f"t_pb{rid}"), name="t_pb") as (router, _):
        outs = _serve(router, reqs)
    for o, r in zip(outs, reqs):
        want = pp.run([r])[0]
        assert want.dtype == o.dtype == ml_dtypes.bfloat16
        assert o.tobytes() == want.tobytes() and o.shape == want.shape


def test_gpt_tiny_streams_match_reference_engine(tmp_path):
    jm, tm = make_pair()
    _, pm = _mlp(0)
    port_predictor(pm, str(tmp_path / "m"), [None, 8], "float32", "x")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 256, int(n)).tolist()
               for n in (5, 17, 9, 30, 3, 12)]
    news = [8, 6, 10, 5, 7, 9]
    ref = JServer(jm, max_batch=4, page_size=8, name="t_jgen")
    try:
        want = [ref.generate(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]
    finally:
        ref.shutdown()
    backends = []

    def factory(rid):
        be = pfleet.PredictorBackend(
            str(tmp_path / "m"), device="cpu", name=f"t_pg{rid}",
            generation_model=tm,
            generation_kwargs={"max_batch": 4, "page_size": 8})
        backends.append(be)
        return be

    with _fleet(pfleet, factory, name="t_pg") as (router, _):
        futs = [router.submit_generate(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]
        got = [f.result(WAIT_S) for f in futs]
        reasons = [f.finish_reason for f in futs]
    assert got == want
    assert reasons == ["length"] * len(prompts)
    served = [be.generation_server.metrics_snapshot()["counters"]
              ["completed"] for be in backends]
    assert sum(served) == len(prompts) and all(served)
    assert all(be.generation_server.leak_check()["ok"] for be in backends)


def test_left_out_paths_raise_naming_their_items(tmp_path):
    _, pm = _mlp(0)
    port_predictor(pm, str(tmp_path / "m"), [None, 8], "float32", "x")
    # the manifest warmup is ported (tests/test_torch_warmup_manifest.py):
    # without a compile-cache directory it replays nothing and flips ready
    be = pfleet.PredictorBackend(str(tmp_path / "m"), device="cpu",
                                 warmup_mode="manifest")
    try:
        assert not be.ready() and be.server.warmup_manifest is None
        assert be.warmup() == 0 and be.ready()
    finally:
        be.shutdown()
    pflags.set_flags({"FLAGS_serving_mesh_mp": 2})
    try:
        with pytest.raises(NotImplementedError, match="5c"):
            pfleet.PredictorBackend(str(tmp_path / "m"), device="cpu")
    finally:
        pflags.set_flags({"FLAGS_serving_mesh_mp": 1})
    be = pfleet.StubBackend()
    app = pfleet.ReplicaApp(be)
    assert pfleet.arm_canary(be, app) is None
    # the canary is ported (tests/test_torch_fleet_canary.py): a period
    # above 0 starts its runner, which sweeps the stub's probe at once
    runner = pfleet.arm_canary(be, app, period_s=1.0)
    try:
        assert runner is app.canary and runner.period_s == 1.0
        deadline = time.monotonic() + 10
        while runner.last is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert runner.last["ok"] and runner.last["probe"]["ok"]
    finally:
        runner.stop()
    from paddle_tpu_torch.serving.fleet import worker
    assert worker._parse_args(["--stub", "--warmup",
                               "manifest"]).warmup == "manifest"
    args = worker._parse_args(["--model-prefix", "x", "--cpu"])
    assert args.cpu and args.warmup == "auto"
    engine = GenerationServer(make_pair()[1], max_batch=2, page_size=8,
                              name="t_pleft", device="cpu", start=False)
    try:
        assert engine.warmup_manifest is None
        assert not engine._warmed.is_set()
        # as the reference's: nothing to replay warms nothing
        assert engine.warmup_from_manifest() == 0
        assert not engine._warmed.is_set()
    finally:
        engine.shutdown()
