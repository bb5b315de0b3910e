"""``paddle.distributed`` of the port: the counterpart of
``paddle_tpu/distributed``, in the reference's two regimes.

- **Processes** (eager): ranks started by the launcher
  (``python -m paddle_tpu_torch.distributed.launch``) or ``spawn`` find each
  other through the environment contract and a TCPStore
  (``init_parallel_env``), and run the collectives (``all_reduce``, ...)
  over a ``torch.distributed`` process group: NCCL when every rank has a
  card of its own, gloo otherwise (``env.py``). ``DataParallel`` averages
  gradients over them; ``fleet.init`` builds the hybrid topology.
- **The mesh** (one process, many device slots; ``mesh_utils.py``):
  ``build_mesh``, the sharding rules and placement (``shard.py``), the
  tensor-parallel layers (``fleet.meta_parallel``) and the serving mesh
  (``serving/mesh.py``) that runs tensor-parallel decode.

Waiting for ROADMAP queue 1 item 5c, part 2, each raising
``NotImplementedError`` naming it: ``auto``/``auto_parallel``
(``ProcessMesh``, ``shard_op``, ``shard_tensor``), ``rpc``, ``sharding``
(``group_sharded_parallel``, ``save_group_sharded_model``). The
parameter-server placeholders (``InMemoryDataset``, ``QueueDataset`` and
the ``*Entry`` classes) raise as the reference's do: that stack is out of
scope.
"""
from __future__ import annotations

import os

from . import communication, env, fleet, group, io, launch  # noqa: F401
from . import mesh_utils, parallel, shard  # noqa: F401
from ._part2 import part2 as _part2
from .communication import *  # noqa: F401,F403
from .communication import collective  # noqa: F401
from .communication.collective import (  # noqa: F401
    ReduceOp, all_to_all as alltoall, all_to_all_single as alltoall_single,
)
from .env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .group import (  # noqa: F401
    Group, destroy_process_group, get_group, new_group,
)
from .mesh_utils import (  # noqa: F401
    build_mesh, get_global_mesh, set_global_mesh, shard_tensor_data,
    with_constraint,
)
from .parallel import DataParallel  # noqa: F401
from .shard import (  # noqa: F401
    apply_sharding, constrain, constrain_batch, constrain_seq,
    shard_params, spec_tree, spec_tree_hash,
)

auto = _part2("distributed.auto")
auto_parallel = _part2("distributed.auto_parallel")
ProcessMesh = _part2("distributed.ProcessMesh")
shard_op = _part2("distributed.shard_op")
shard_tensor = _part2("distributed.shard_tensor")
rpc = _part2("distributed.rpc")
group_sharded_parallel = _part2("distributed.group_sharded_parallel")
save_group_sharded_model = _part2("distributed.save_group_sharded_model")
sharding = _part2("distributed.sharding")


class ParallelMode:
    """The reference's ``parallel.py`` ParallelMode constants."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def is_available() -> bool:
    """Whether ``torch.distributed`` is built in (a world of one works
    without it)."""
    import torch.distributed as dist
    return dist.is_available()


def get_backend(group=None) -> str:
    """The process group's backend ("nccl" or "gloo"); before
    ``init_parallel_env`` the one the backend rule gives a process alone:
    "nccl" with a card, "gloo" without."""
    chosen = env.backend()
    if chosen is not None:
        return chosen
    import torch
    import torch.distributed as dist
    return "nccl" if torch.cuda.is_available() and \
        dist.is_nccl_available() else "gloo"


def _spawn_entry(index, func, args, world, master):
    os.environ.update({
        "PADDLE_TRAINER_ID": str(index),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_RANK_IN_NODE": str(index),
        "PADDLE_MASTER": master,
        "TRAINING_ROLE": "TRAINER",
    })
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """``paddle.distributed.spawn``: ``nprocs`` processes on this host
    (``-1``: one a visible card, at least one), started with the spawn
    method (``torch.multiprocessing``), each with the launcher's
    environment (rank, world, a fresh ``PADDLE_MASTER``) and running
    ``func(*args)``. ``join`` waits for all and raises if one failed;
    otherwise the ``ProcessContext`` is returned."""
    import socket

    import torch
    import torch.multiprocessing as mp
    n = nprocs if nprocs > 0 else max(1, torch.cuda.device_count()
                                      if torch.cuda.is_available() else 1)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    master = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return mp.start_processes(_spawn_entry, args=(func, tuple(args), n,
                                                  master),
                              nprocs=n, join=join, daemon=daemon,
                              start_method="spawn")


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The reference's gloo bootstrap: the explicit arguments override the
    environment, then ``init_parallel_env``."""
    os.environ["PADDLE_TRAINER_ID"] = str(rank_id)
    os.environ["PADDLE_TRAINERS_NUM"] = str(rank_num)
    os.environ["PADDLE_MASTER"] = server_endpoint
    return init_parallel_env()


def gloo_barrier():
    from .communication.collective import barrier
    return barrier()


def gloo_release():
    """Tear the rendezvous down (the world's process group and store)."""
    destroy_process_group()


def _ps_out_of_scope(name):
    class _PS:
        __not_ported__ = True

        def __init__(self, *a, **k):
            raise NotImplementedError(
                f"{name} belongs to the parameter-server/recsys stack, "
                "which SURVEY §2.3 excludes from the core scope; use "
                "paddle.io.Dataset/DataLoader for data feeding")
    _PS.__name__ = name
    return _PS


InMemoryDataset = _ps_out_of_scope("InMemoryDataset")
QueueDataset = _ps_out_of_scope("QueueDataset")
CountFilterEntry = _ps_out_of_scope("CountFilterEntry")
ProbabilityEntry = _ps_out_of_scope("ProbabilityEntry")
ShowClickEntry = _ps_out_of_scope("ShowClickEntry")


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the tensor's pending work is done (a device sync on
    the card)."""
    import torch
    data = getattr(tensor, "_data", tensor)
    if isinstance(data, torch.Tensor) and data.is_cuda:
        torch.cuda.synchronize(data.device)
    return tensor


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """The reference's ``distributed.split``: a linear or embedding whose
    weight is split over the model-parallel slots, through the TP layers
    (``fleet.meta_parallel``)."""
    from .fleet.meta_parallel import (ColumnParallelLinear,
                                      RowParallelLinear,
                                      VocabParallelEmbedding)
    data = getattr(x, "_data", x)
    if operation == "embedding" and axis != 0:
        raise ValueError(
            "split(operation='embedding') only supports axis=0 "
            "(vocab-dimension partitioning), matching the reference")
    has_bias = bias_attr is not False
    kw = {"device": data.device}
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      input_is_parallel=False,
                                      weight_attr=weight_attr,
                                      has_bias=has_bias, **kw)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         gather_output=gather_out,
                                         weight_attr=weight_attr,
                                         has_bias=has_bias, **kw)
        return layer.to(data.dtype)(data)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr, **kw)
        return layer(data)
    raise ValueError(f"unsupported split operation {operation!r}")
