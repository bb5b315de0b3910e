"""One rank of the four-rank gloo job that ``test_torch_dist_process.py``
starts through the port's launcher::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        tests/torch_dist_job.py OUT_DIR

It runs every eager collective (``tools/dp_worker.run_collectives``), the
group operations, a collective whose ranks disagree, a two-rank
``DataParallel`` on a group of ranks 0 and 1, and ``Model.fit`` over a
dataset sharded by the world's sampler; each rank writes what it saw to
``OUT_DIR/rank<r>.json`` (and its collectives' results to an npz). The
port only: the test process holds the results against the JAX package.
"""
import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch.tools import dp_worker  # noqa: E402

FIT_SAMPLES = 22
DP_ARGS = SimpleNamespace(model="tiny", layers=2, steps=3, batch=4, seq=16,
                          amp="none")


class Samples(paddle.io.Dataset):
    """``FIT_SAMPLES`` regression samples that record which indices this
    rank read."""

    def __init__(self):
        self.seen = []

    def __len__(self):
        return FIT_SAMPLES

    def __getitem__(self, i):
        self.seen.append(int(i))
        x = np.full(4, i, np.float32) / FIT_SAMPLES
        return x, x[:1] * 2


def main(out):
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    penv = dist.init_parallel_env()
    rank, n = dist.get_rank(), dist.get_world_size()
    res = {"rank": rank, "world": n, "backend": penv.backend,
           "initialized": dist.is_initialized(),
           "env": {k: os.environ.get(k) for k in (
               "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
               "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
               "PADDLE_RANK_IN_NODE", "PADDLE_MASTER", "TRAINING_ROLE")},
           "current_endpoint": penv.current_endpoint}
    got = dp_worker.run_collectives("cpu")
    np.savez(os.path.join(out, f"collectives.{rank}.npz"), **got)
    t = torch.full((3,), float(rank))
    task = dist.all_reduce(t, op=dist.ReduceOp.MAX, sync_op=False)
    task.wait()
    res["async_max"] = t.tolist()

    # groups: every rank builds both, in the same order
    g02, g13 = dist.new_group([0, 2]), dist.new_group([1, 3])
    mine = g02 if rank in (0, 2) else g13
    t = torch.full((2,), float(rank))
    dist.all_reduce(t, group=mine)
    lst = []
    dist.all_gather(lst, torch.tensor([float(rank)]), group=mine)
    b = torch.tensor([float(rank)])
    dist.broadcast(b, src=mine.ranks[-1], group=mine)
    res["group"] = {"ranks": mine.ranks, "rank": mine.rank,
                    "nranks": mine.nranks, "sum": t.tolist(),
                    "gather": [x.item() for x in lst],
                    "broadcast": b.item(),
                    "get_rank": dist.get_rank(mine)}
    try:
        dist.broadcast(b, src=(mine.ranks[0] + 1) % n, group=mine)
        res["group"]["foreign_root"] = "no error"
    except ValueError as e:
        res["group"]["foreign_root"] = str(e)

    # a rank that disagrees
    try:
        dist.all_reduce(torch.zeros(4 if rank == 3 else 3))
        res["mismatch"] = "no error"
    except dist.collective.CollectiveMismatchError as e:
        res["mismatch"] = str(e)

    # two-rank DataParallel on the group of ranks 0 and 1
    g01 = dist.new_group([0, 1])
    if rank in (0, 1):
        model, crit, cfg = dp_worker.build(DP_ARGS, "cpu")
        model = dist.DataParallel(model, group=g01)
        ids = dp_worker.batch(cfg, DP_ARGS, "cpu")
        half = ids[rank * 2:(rank + 1) * 2]
        grad0, losses, _ = dp_worker.train(model, crit, half, DP_ARGS)
        res["dp_losses"] = losses
        res["dp_reductions"] = model.reductions
        if rank == 0:
            torch.save(grad0, os.path.join(out, "dp_grad0.pt"))
            torch.save(model._layers.state_dict(),
                       os.path.join(out, "dp_params.pt"))
        # no_sync: a local gradient inside, the accumulated one averaged
        # by the first backward after it
        lin = torch.nn.Linear(3, 1, bias=False)
        dp = dist.DataParallel(lin, group=g01)
        x = torch.full((2, 3), float(rank + 1))
        with dp.no_sync():
            dp(x).sum().backward()
        res["no_sync_local"] = lin.weight.grad.flatten().tolist()
        dp(x).sum().backward()
        res["no_sync_then_synced"] = lin.weight.grad.flatten().tolist()
    dist.barrier()

    # Model.fit over the world's sampler
    net = paddle.nn.Linear(4, 1)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(learning_rate=0.01,
                                       parameters=net.parameters()),
                  paddle.nn.MSELoss())
    data = Samples()
    model.fit(data, batch_size=2, epochs=1, shuffle=False, verbose=0)
    res["fit_seen"] = data.seen
    dist.barrier()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    res_after = dist.is_initialized()
    assert not res_after


if __name__ == "__main__":
    main(sys.argv[1])
