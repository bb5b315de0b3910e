"""Warmup manifests in the port's two servers and the fleet worker, against
``paddle_tpu``'s on the same operations, on the CPU.

- ``InferenceServer``: traffic (never a warmup's batches) is written to the
  manifest, the same signatures as the reference server's; a fresh server
  replays it with ``warmup_from_manifest`` and returns the reference's
  count. The reference runs with its compile cache off (its cached
  executables do not load on this host, a known fault of the reference),
  a manifest attached to the server by hand, and replays its file through
  ``path=``. The port's replay is all compile-cache hits,
  the snapshot's ``compile_cache`` reads 0 misses, and the answers are bit
  for bit the first server's. ``FLAGS_serving_warmup_from_manifest``
  replays at construction.
- ``GenerationServer`` (``gpt_tiny``, the prefix cache and self-speculation,
  both engines driven by the same ``_admit_and_prefill`` /
  ``_decode_iteration`` calls): the same sites and signatures as the
  reference's manifest, the reference's replay count, 0 misses, the same
  streams.
- ``/statusz``'s ``compile_cache`` section has the reference's keys; the
  fleet worker's ``--warmup manifest`` replays the shared manifest, and the
  process factory hands its cache directory to the workers it spawns.

One temporary directory per test.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

from paddle_tpu import compile_cache as jcc
from paddle_tpu import serving as jserving
from paddle_tpu.framework import flags as jflags
from paddle_tpu.serving.generation import GenerationServer as JServer
from paddle_tpu_torch import compile_cache as pcc
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.observability import xstats as px
from paddle_tpu_torch.serving.generation import GenerationServer
from test_torch_flags import pin_kv_dtype  # noqa: F401
from test_torch_generation import make_pair
from test_torch_inference import jax_predictor, mlp_pair, port_predictor

DIR = "FLAGS_compile_cache_dir"


@contextlib.contextmanager
def _cache(flags, cc, directory):
    flags.set_flags({DIR: str(directory) if directory else ""})
    cc.reset_default_cache()
    try:
        yield
    finally:
        flags.set_flags({DIR: ""})
        cc.reset_default_cache()


@pytest.fixture(autouse=True)
def _fresh_xstats():
    px.reset_for_tests()
    yield
    px.reset_for_tests()


def _canon(manifest):
    return sorted(json.dumps([s["site"], [[list(sh), d]
                                          for sh, d in s["feeds"]]])
                  for s in manifest.specs())


def _stats():
    return pcc.stats()


def _delta(before):
    now = _stats()
    return {k: now[k] - before[k] for k in ("hits", "misses")}


ROWS = (1, 2, 3)


def _traffic(srv):
    rng = np.random.RandomState(5)
    return [srv.submit([rng.randn(r, 8).astype(np.float32)]).result(60)[0]
            for r in ROWS]


def test_inference_server_manifest_round_trip(tmp_path):
    jm, pm = mlp_pair()
    mk = {"jax": lambda: jax_predictor(jm, str(tmp_path / "j"), [None, 8],
                                       "float32", "x"),
          "port": lambda: port_predictor(pm, str(tmp_path / "p"),
                                         [None, 8], "float32", "x")}
    manifests, outs = {}, {}
    for tag, pkg, flags, cc in (("jax", jserving, jflags, jcc),
                                ("port", serving, pflags, pcc)):
        with _cache(flags, cc, tmp_path / "cc" if tag == "port" else None):
            srv = pkg.InferenceServer(mk[tag](), max_batch_size=4,
                                      name="tw_srv")
            if tag == "jax":
                srv._manifest = jcc.WarmupManifest(str(tmp_path / "j.json"))
            srv.warmup([4])              # a warmup is not traffic
            outs[tag] = _traffic(srv)
            manifests[tag] = srv.warmup_manifest
            srv.shutdown()
    assert _canon(manifests["port"]) == _canon(manifests["jax"])
    assert [s["feeds"][0][0] for s in manifests["port"].specs()] == \
        [(1, 8), (2, 8), (4, 8)]
    # the reference replays its file with its cache off (path=)
    jsrv = jserving.InferenceServer(mk["jax"](), max_batch_size=4,
                                    name="tw_srv_j2", start=False)
    want = jsrv.warmup_from_manifest(path=manifests["jax"].path)
    jsrv.shutdown()
    with _cache(pflags, pcc, tmp_path / "cc"):
        before = _stats()
        srv = serving.InferenceServer(mk["port"](), max_batch_size=4,
                                      name="tw_srv",
                                      ready_requires_warmup=True)
        assert not srv.ready
        got = srv.warmup_from_manifest()
        assert srv.ready and got == want == len(ROWS)
        assert _delta(before) == {"hits": len(ROWS), "misses": 0}
        again = _traffic(srv)
        cc = srv.metrics.snapshot()["compile_cache"]
        srv.shutdown()
        assert cc["misses"] == 0 and cc["signatures"] == len(ROWS)
        assert cc["hits"] == 2 * len(ROWS)      # replay, then traffic
        for a, b in zip(again, outs["port"]):
            assert np.array_equal(a, b)
        # the flag replays a non-empty manifest at construction
        pflags.set_flags({"FLAGS_serving_warmup_from_manifest": True})
        try:
            before = _stats()
            auto = serving.InferenceServer(mk["port"](), max_batch_size=4,
                                           name="tw_srv", start=False,
                                           ready_requires_warmup=True)
        finally:
            pflags.set_flags({"FLAGS_serving_warmup_from_manifest": False})
        assert auto.ready
        assert _delta(before) == {"hits": len(ROWS), "misses": 0}
        auto.shutdown()


def _drive(srv, prompts, seed0):
    """Submit, then run the engine's own admission and decode calls until
    every stream ends (the same calls in both packages)."""
    futs = [srv.submit_generate(p, max_new_tokens=6, temperature=0.0,
                                seed=seed0 + i)
            for i, p in enumerate(prompts)]
    ctx = torch.inference_mode() if isinstance(srv, GenerationServer) \
        else contextlib.nullcontext()
    with ctx:
        for _ in range(64):
            srv._admit_and_prefill()
            active = [s for s in srv._slots if s is not None]
            if not active and not srv._queue:
                break
            if active and srv.draft is not None:
                srv._spec_iteration(active)
            elif active:
                srv._decode_iteration(active)
    return [f.result(1) for f in futs]


def _waves():
    rng = np.random.RandomState(3)
    system = rng.randint(1, 256, 16).tolist()
    first = [system + rng.randint(1, 256, n).tolist() for n in (4, 9)]
    second = [system + rng.randint(1, 256, 3).tolist()]
    return first, second


def test_generation_server_manifest_round_trip(tmp_path):
    jm, tm = make_pair()
    first, second = _waves()
    kw = dict(max_batch=2, page_size=8, start=False, spec_k=2)
    manifests, streams = {}, {}
    for tag, flags, cc, make in (
            ("jax", jflags, jcc, lambda: JServer(
                jm, draft_model=jm, name="tw_gen", **kw)),
            ("port", pflags, pcc, lambda: GenerationServer(
                tm, draft_model=tm, name="tw_gen", device="cpu", **kw))):
        with _cache(flags, cc, tmp_path / "cc" if tag == "port" else None):
            srv = make()
            if tag == "jax":
                srv._manifest = jcc.WarmupManifest(str(tmp_path / "j.json"))
            srv.warmup(seq_buckets=[8], batch_buckets=[1])   # not traffic
            streams[tag] = _drive(srv, first, 0) + _drive(srv, second, 9)
            manifests[tag] = srv.warmup_manifest
            srv.shutdown()
    assert streams["port"] == streams["jax"]
    assert _canon(manifests["port"]) == _canon(manifests["jax"])
    sites = {s["site"] for s in manifests["port"].specs()}
    assert sites == {"generate_prefill", "generate_chunked",
                     "generate_verify"}
    # the lattice warmup's prefill (1, 8) ran, but is not traffic
    assert (1, 8) not in [s["feeds"][0][0] for s in
                          manifests["port"].specs(site="generate_prefill")]
    jsrv = JServer(jm, draft_model=jm, name="tw_gen_j2", **kw)
    want = jsrv.warmup_from_manifest(path=manifests["jax"].path)
    jsrv.shutdown()
    with _cache(pflags, pcc, tmp_path / "cc"):
        before = _stats()
        srv = GenerationServer(tm, draft_model=tm, name="tw_gen",
                               device="cpu", **kw)
        got = srv.warmup_from_manifest()
        assert got == want > 0
        d = _delta(before)
        assert d["misses"] == 0 and d["hits"] > 0
        assert _drive(srv, first, 0) + _drive(srv, second, 9) == \
            streams["port"]
        assert srv.metrics_snapshot()["compile_cache"]["misses"] == 0
        assert _delta(before)["misses"] == 0
        srv.shutdown()


def test_statusz_compile_cache_keys_equal_the_reference(tmp_path):
    from paddle_tpu.observability import httpd as jhttpd
    from paddle_tpu_torch.observability import httpd as phttpd
    with _cache(pflags, pcc, tmp_path / "p"), \
            _cache(jflags, jcc, tmp_path / "j"):
        pcc.default_cache()
        jcc.default_cache()
        got = phttpd._statusz()["compile_cache"]
        want = jhttpd._statusz()["compile_cache"]
    assert set(got) == set(want)
    assert got["enabled"] and got["dir"] == str(tmp_path / "p")


def test_fleet_worker_replays_the_shared_manifest(tmp_path, monkeypatch):
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import supervisor, worker
    _, pm = mlp_pair()
    prefix = str(tmp_path / "m")
    port_predictor(pm, prefix, [None, 8], "float32", "x")
    with _cache(pflags, pcc, tmp_path / "cc"):
        # the workers of one fleet share a name, so one manifest
        cold = fleet.PredictorBackend(prefix, device="cpu", name="replica",
                                      max_batch_size=4,
                                      warmup_mode="lattice")
        cold.warmup()
        _traffic(cold.server)
        cold.shutdown()
        before = _stats()
        warm = fleet.PredictorBackend(prefix, device="cpu", name="replica",
                                      max_batch_size=4,
                                      warmup_mode="manifest")
        assert not warm.ready()
        assert warm.warmup() == len(ROWS) and warm.ready()
        rep = worker._warm_report(warm)
        assert rep == {"compile_cache": {
            "hits": before["hits"] + len(ROWS),
            "misses": before["misses"]}, "manifest_signatures": len(ROWS)}
        warm.shutdown()
        # the factory hands the live cache directory to its workers
        seen = {}

        class _Popen:
            pid = 0

            def __init__(self, cmd, env=None, **kw):
                seen.update(env=env, cmd=cmd)

        monkeypatch.setattr(supervisor.subprocess, "Popen", _Popen)
        fac = fleet.ProcessReplicaFactory(extra_args=["--stub"],
                                          announce_dir=str(tmp_path))
        fac(0)
        assert seen["env"][DIR] == str(tmp_path / "cc")
        fac.env = {DIR: "/elsewhere"}
        fac(1)
        assert seen["env"][DIR] == "/elsewhere"
    assert worker._parse_args(["--stub", "--warmup", "manifest"]).warmup \
        == "manifest"
