"""The port's fleet with real worker processes (``ProcessReplicaFactory``
spawning ``python -m paddle_tpu_torch.serving.fleet.worker``), on the CPU.

- A ``--stub`` worker under a ``ReplicaSupervisor`` and a ``FleetRouter``:
  the spawned process is the port's worker (its command line and its
  ``/statusz``), traffic flows, a crash request kills it mid-batch (only
  that request fails, typed), the supervisor respawns it and the router is
  back to one ready replica.
- One ``--cpu --model-prefix`` worker over the MLP saved by the port's
  ``jit.save``: its outputs equal the port's ``Predictor.run`` on each
  request and are within rtol 1e-5 / atol 1e-6 of the reference's; its
  version stamp carries the fingerprint computed in this process.
- Without a GPU and without ``--cpu`` the worker exits non-zero with the
  device error.

At most two worker processes live at once; every wait has its own bound.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving import fleet as pfleet
from paddle_tpu_torch.serving.fleet.supervisor import WORKER_MODULE
from test_torch_inference import (MLP_ATOL, MLP_RTOL, jax_predictor,
                                  mlp_pair, port_predictor)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
SPAWN_S = 120.0


def _wait(cond, what, timeout=SPAWN_S):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"{what}: timed out"
        time.sleep(0.05)


def _cmdline(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().split(b"\0")


def test_stub_worker_process_crash_and_respawn(tmp_path):
    fac = pfleet.ProcessReplicaFactory(
        extra_args=["--stub", "--stub-device-ms", "1",
                    "--stub-crash-value", "666"],
        env=ENV, announce_dir=str(tmp_path))
    sup = pfleet.ReplicaSupervisor(fac, 1, restart_backoff_ms=50,
                                   poll_interval_s=0.02,
                                   name="t_proc").start()
    router = pfleet.FleetRouter(supervisor=sup, name="t_proc", start=False)
    try:
        assert router.wait_ready(1, timeout=SPAWN_S)
        first = sup._managed[0].proc.pid
        assert WORKER_MODULE == "paddle_tpu_torch.serving.fleet.worker"
        assert WORKER_MODULE.encode() in _cmdline(first)
        (url,) = sup.endpoints().values()
        with router._http(url + "/statusz") as st:
            info = json.loads(st.read())
        assert info["package"] == "paddle_tpu_torch.serving.fleet"
        assert info["backend"] == "stub"
        scale = pfleet.StubBackend._scale_of("v0")
        x = np.full((2, 4), 1.5, np.float32)
        np.testing.assert_array_equal(router.submit([x]).result(60)[0],
                                      x * scale)
        with pytest.raises(pfleet.ReplicaError):
            router.submit([np.full((1, 4), 666.0, np.float32)]).result(60)
        _wait(lambda: sup.restart_counts()[0] == 1, "respawn")
        _wait(lambda: (router.poll_replicas() or
                       len(router._routable()) == 1), "ready again")
        assert sup._managed[0].proc.pid != first
        np.testing.assert_array_equal(router.submit([x]).result(60)[0],
                                      x * scale)
        assert router.statusz()["restarts_total"] == 1
        assert router.metrics_snapshot()["counters"]["failed"] == 1
    finally:
        router.shutdown()
        sup.stop()


def test_cpu_worker_process_matches_predictor(tmp_path):
    jm, pm = mlp_pair()
    prefix = str(tmp_path / "mlp_v1")
    pp = port_predictor(pm, prefix, [None, 8], "float32", "x")
    jp = jax_predictor(jm, str(tmp_path / "j"), [None, 8], "float32", "x")
    fac = pfleet.ProcessReplicaFactory(
        extra_args=["--cpu", "--model-prefix", prefix, "--max-batch-size",
                    "4", "--warmup", "lattice"],
        env=ENV, announce_dir=str(tmp_path))
    sup = pfleet.ReplicaSupervisor(fac, 1, name="t_cpuw").start()
    router = pfleet.FleetRouter(supervisor=sup, name="t_cpuw", start=False)
    try:
        assert router.wait_ready(1, timeout=SPAWN_S)
        rng = np.random.RandomState(2)
        reqs = [rng.randn(int(n), 8).astype(np.float32)
                for n in rng.randint(1, 5, 10)]
        outs = [f.result(60)[0] for f in router.submit_many(
            [[r] for r in reqs])]
        for o, r in zip(outs, reqs):
            np.testing.assert_allclose(o, pp.run([r])[0], rtol=MLP_RTOL,
                                       atol=MLP_ATOL)
            np.testing.assert_allclose(o, jp.run([r])[0], rtol=MLP_RTOL,
                                       atol=MLP_ATOL)
        (state,) = router.replica_states()
        assert state["version"] == \
            f"mlp_v1@{pp.artifact_fingerprint()[:8]}"
    finally:
        router.shutdown()
        sup.stop()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a GPU")
def test_worker_without_gpu_or_cpu_flag_exits_with_the_device_error(
        tmp_path):
    _, pm = mlp_pair()
    prefix = str(tmp_path / "m")
    port_predictor(pm, prefix, [None, 8], "float32", "x")
    env = dict(os.environ, **ENV)
    # --warmup manifest is ported: the parser takes it, and the worker
    # fails on the device before any warmup (one process for both)
    proc = subprocess.run([sys.executable, "-m", WORKER_MODULE,
                           "--model-prefix", prefix, "--warmup", "manifest"],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
