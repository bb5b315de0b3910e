"""Port parity: the process layer (``paddle_tpu_torch/distributed``: the
launcher, ``init_parallel_env`` over a TCPStore, groups, the eager
collectives, ``DataParallel``, ``spawn``, ``Model.fit``'s sharded data) on
the CPU, over gloo.

One module-scoped job of four ranks runs through the port's launcher
(``tests/torch_dist_job.py``); the tests hold what each rank saw against
numpy and the JAX package: every collective against the reference's own
``_np_reduce``, the groups' rank numbering, a rank that disagrees failing
typed, a two-rank ``DataParallel`` against one process on the whole batch
(float32, rtol 1e-5), and ``fit``'s shards against the reference's
``DistributedBatchSampler``. Every job runs with a timeout of its own and
its whole process group is killed when it ends.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.communication.collective import \
    _np_reduce as j_np_reduce
from paddle_tpu_torch.native.tcp_store import TCPStore, TCPStoreServer
from paddle_tpu_torch.tools import dp_worker
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOB_TIMEOUT_S = 240


def _launch(args, timeout=JOB_TIMEOUT_S, env=None):
    """``python -m paddle_tpu_torch.distributed.launch`` with ``args``, in a
    process group of its own, killed whole when it ends."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *args], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
        env={**os.environ, **(env or {})})
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode, out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_job")
    rc, log = _launch(["--nproc_per_node", str(WORLD), "--log_dir",
                       str(out / "logs"), str(REPO / "tests" /
                                              "torch_dist_job.py"),
                       str(out)])
    logs = "".join(p.read_text()[-2000:]
                   for p in sorted((out / "logs").glob("workerlog.*")))
    assert rc == 0, log + logs
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return SimpleNamespace(out=out, ranks=ranks)


def test_launcher_sets_the_reference_env_contract(job):
    eps = job.ranks[0]["env"]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == WORLD
    for r, res in enumerate(job.ranks):
        env = res["env"]
        assert env["PADDLE_TRAINER_ID"] == str(r)
        assert env["PADDLE_TRAINERS_NUM"] == str(WORLD)
        assert env["PADDLE_RANK_IN_NODE"] == str(r)
        assert env["PADDLE_CURRENT_ENDPOINT"] == eps[r] == \
            res["current_endpoint"]
        assert env["TRAINING_ROLE"] == "TRAINER"
        assert env["PADDLE_MASTER"].startswith("127.0.0.1:")
        assert res["backend"] == "gloo" and res["initialized"]


def test_every_collective_matches_numpy_and_the_reference(job):
    for r in range(WORLD):
        got = dict(np.load(job.out / f"collectives.{r}.npz"))
        want = dp_worker.expected_collectives(WORLD, r, reduce_fn=j_np_reduce)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"rank {r} {name}")
        assert job.ranks[r]["async_max"] == [3.0] * 3


def test_groups_number_ranks_within_the_group(job):
    for r, res in enumerate(job.ranks):
        g = res["group"]
        members = [0, 2] if r in (0, 2) else [1, 3]
        assert g["ranks"] == members and g["nranks"] == 2
        assert g["rank"] == g["get_rank"] == members.index(r)
        assert g["sum"] == [float(sum(members))] * 2
        assert g["gather"] == [float(m) for m in members]
        assert g["broadcast"] == float(members[-1])
        assert "not a member of the group" in g["foreign_root"]


def test_a_rank_that_disagrees_fails_typed_on_every_rank(job):
    for res in job.ranks:
        msg = res["mismatch"]
        assert "mismatched tensors" in msg, msg
        assert "rank 3: shape=(4,)" in msg and "rank 0: shape=(3,)" in msg


def test_two_rank_data_parallel_matches_one_process(job):
    args = SimpleNamespace(model="tiny", layers=2, steps=3, batch=4, seq=16,
                           amp="none")
    torch.manual_seed(0)
    model, grad0, losses = dp_worker.single_process(args, "cpu")
    dp_grad = torch.load(job.out / "dp_grad0.pt")
    assert set(dp_grad) == set(grad0)
    for name, g in grad0.items():
        torch.testing.assert_close(dp_grad[name], g, rtol=1e-5, atol=1e-7,
                                   msg=name)
    dp_params = torch.load(job.out / "dp_params.pt")
    for name, p in model.state_dict().items():
        torch.testing.assert_close(dp_params[name], p, rtol=1e-5, atol=1e-6,
                                   msg=name)
    assert job.ranks[0]["dp_reductions"] == 1 + args.steps
    # each rank's loss is its half's; their mean is the whole batch's
    mean = np.mean([job.ranks[r]["dp_losses"][0] for r in (0, 1)])
    np.testing.assert_allclose(mean, losses[0], rtol=1e-5)


def test_no_sync_accumulates_locally_then_averages(job):
    for r in (0, 1):
        assert job.ranks[r]["no_sync_local"] == [2.0 * (r + 1)] * 3
        # (2 x 2 + 2 x 4) / 2: each rank's two backwards, then the mean
        assert job.ranks[r]["no_sync_then_synced"] == [6.0] * 3


def test_fit_reads_the_worlds_shards(job):
    from paddle_tpu.io import DistributedBatchSampler as JSampler

    class Stub:
        def __len__(self):
            return 22

    seen = [res["fit_seen"] for res in job.ranks]
    for r, got in enumerate(seen):
        want = [i for batch in JSampler(Stub(), batch_size=2,
                                        num_replicas=WORLD, rank=r)
                for i in batch]
        assert got == want
    assert set().union(*map(set, seen)) == set(range(22))


def test_launcher_exit_code_is_the_first_failing_ranks(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(
        "import os, sys, time\n"
        "r = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if r == 1:\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    rc, out = _launch(["--nproc_per_node", "2", str(script)], timeout=60)
    assert rc == 3
    assert "rank 1 exited with code 3" in out


def _spawned(out_dir):
    import paddle_tpu_torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_parallel_env()
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    Path(out_dir, f"{dist.get_rank()}.txt").write_text(str(t.item()))
    dist.destroy_process_group()


def test_spawn_starts_ranks_that_rendezvous(tmp_path):
    import paddle_tpu_torch.distributed as dist
    dist.spawn(_spawned, args=(str(tmp_path),), nprocs=2)
    assert [float(Path(tmp_path, f"{r}.txt").read_text())
            for r in range(2)] == [3.0, 3.0]


def test_tcp_store_keeps_the_reference_api():
    server = TCPStoreServer(0)
    a = TCPStore("127.0.0.1", server.port, timeout=5.0)
    b = TCPStore("127.0.0.1", server.port, timeout=5.0)
    a.set("k", "v")
    assert b.get("k") == b"v"
    with pytest.raises(KeyError):
        b.get("missing")
    assert a.add("n", 2) == 2 and b.add("n", 3) == 5
    with pytest.raises(TimeoutError):
        b.wait("never", timeout=0.2)
    a.delete("k")
    with pytest.raises(KeyError):
        a.get("k")
    a.close()
    b.close()
    server.stop()


def test_a_world_of_one_is_the_identity():
    import paddle_tpu_torch.distributed as dist
    assert dist.get_world_size() == 1 and not dist.is_initialized()
    t = torch.ones(3)
    dist.all_reduce(t)
    lst = []
    dist.all_gather(lst, t)
    assert lst == [t] and torch.equal(t, torch.ones(3))
    model = torch.nn.Linear(2, 2)
    assert dist.DataParallel(model)(torch.ones(1, 2)).shape == (1, 2)


def test_fit_injects_training_telemetry_under_the_flag():
    """``FLAGS_training_telemetry`` adds the callback to ``fit``'s list,
    as the reference's ``config_callbacks`` does."""
    import paddle_tpu as jpaddle
    from paddle_tpu.hapi.callbacks import config_callbacks as j_config
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.hapi.callbacks import config_callbacks

    def names(clist):
        return [type(c).__name__ for c in clist.callbacks]

    for on in (True, False):
        set_flags({"FLAGS_training_telemetry": on})
        jpaddle.set_flags({"FLAGS_training_telemetry": on})
        try:
            for mode in ("train", "eval"):
                got = names(config_callbacks(None, verbose=0, mode=mode))
                want = names(j_config(None, verbose=0, mode=mode))
                assert got == want
                assert ("TrainingTelemetryCallback" in got) == \
                    (on and mode == "train")
        finally:
            set_flags({"FLAGS_training_telemetry": False})
            jpaddle.set_flags({"FLAGS_training_telemetry": False})
