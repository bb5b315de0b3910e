"""The distributed environment and its bootstrap: the port of
``paddle_tpu/distributed/env.py``.

Ranks find each other through the launcher's environment contract
(``launch/main.py``): ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_RANK_IN_NODE``, ``PADDLE_MASTER``, ``TRAINING_ROLE``.
``init_parallel_env`` rendezvouses through a ``TCPStore`` hosted by rank 0
(``native/tcp_store.py``), then builds a ``torch.distributed`` process group
on that store, over which the eager collectives
(``communication/collective.py``) run. A world of one is the identity: no
store, no process group, as the reference's.

**The backend rule.** ``nccl`` when every rank of the world has a CUDA
device of its own (each host's rank count at most its device count, and
NCCL built in), ``gloo`` otherwise. Each rank posts its host and device
count to the store and every rank reads all of them, so the world agrees.
On one card two ranks share ``cuda:0``, and NCCL refuses two ranks on one
device: their collectives run on gloo. The chosen backend is
``ParallelEnv().backend``; nothing changes it after a failure.

There is no ``jax.distributed`` branch: the reference's optional compiled
multi-host path (``PADDLE_JAX_DISTRIBUTED``) has no counterpart, since the
port's eager collectives already run on the device through the process
group.

Elastic heartbeat (``PADDLE_ELASTIC_LEVEL`` above 0): a daemon thread bumps
``hb/<rank>`` on its own store connection, preferably in the launcher's
heartbeat store (``PADDLE_ELASTIC_HB_ENDPOINT``), as the reference's
(``env.py:130-185``).
"""
from __future__ import annotations

import datetime
import json
import os
import socket
from typing import Optional

import torch

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "global_rank",
           "init_parallel_env", "is_initialized", "get_store",
           "parallel_device_count", "backend", "rank_device"]

_initialized = False
_store = None
_backend: Optional[str] = None


def _env_int(name, default=0):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def global_rank() -> int:
    return _env_int("PADDLE_TRAINER_ID", 0)


def get_rank(group=None) -> int:
    if group is not None:
        return group.get_group_rank(global_rank())
    return global_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return _env_int("PADDLE_TRAINERS_NUM", 1)


def get_store():
    """The rendezvous TCPStore; None in a world of one."""
    return _store


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"); None before
    ``init_parallel_env`` (or in a world of one)."""
    return _backend


def local_rank() -> int:
    return _env_int("PADDLE_RANK_IN_NODE", global_rank())


def rank_device() -> torch.device:
    """This rank's device: ``cuda:<local rank mod device count>`` (several
    ranks share a card when there are fewer cards than ranks), else the
    CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def _choose_backend(store, rank: int, n: int, timeout: float) -> str:
    """The backend rule, agreed through the store."""
    import torch.distributed as dist
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    store.set(f"backend/{rank}", json.dumps([socket.gethostname(), count]))
    hosts = {}
    for r in range(n):
        host, c = json.loads(store.wait(f"backend/{r}", timeout))
        ranks = hosts.setdefault(host, [int(c), 0])
        ranks[1] += 1
    own = all(c > 0 and ranks <= c for c, ranks in hosts.values())
    return "nccl" if own and dist.is_nccl_available() else "gloo"


def init_parallel_env():
    """``paddle.distributed.init_parallel_env``: in a world above one,
    rendezvous through rank 0's TCPStore (at ``PADDLE_MASTER``, else one
    port above the first trainer endpoint), pick the backend by the rule
    above, and build the default process group on the store. Returns a
    ``ParallelEnv``."""
    global _initialized, _store, _backend
    if _initialized:
        return ParallelEnv()
    n = _env_int("PADDLE_TRAINERS_NUM", 1)
    rank = _env_int("PADDLE_TRAINER_ID", 0)
    if n > 1:
        import torch.distributed as dist

        from ..native.tcp_store import TCPStore

        master = os.environ.get("PADDLE_MASTER", "")
        if not master:
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            first = eps.split(",")[0] if eps else ""
            host, _, port = first.partition(":")
            if not port or not int(port):
                raise RuntimeError(
                    "multi-process bootstrap needs PADDLE_MASTER=host:port "
                    "(or PADDLE_TRAINER_ENDPOINTS with concrete ports) so "
                    "every rank can find the rank-0 TCPStore; use "
                    "`python -m paddle_tpu_torch.distributed.launch`, which "
                    "sets both")
            master = f"{host}:{int(port) + 1}"
        host, _, port = master.partition(":")
        timeout = float(os.environ.get("PADDLE_STORE_TIMEOUT", "120"))
        _store = TCPStore(host=host or "127.0.0.1", port=int(port or 0),
                          is_master=(rank == 0), timeout=timeout,
                          world_size=n)
        _store.barrier("init_parallel_env", n, timeout)
        _backend = _choose_backend(_store, rank, n, timeout)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank_device())
        dist.init_process_group(
            _backend, store=dist.PrefixStore("paddle_pg", _store.raw),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        if int(os.environ.get("PADDLE_ELASTIC_LEVEL", "0") or 0) > 0:
            _start_heartbeat(_store, rank,
                             rendezvous=(host or "127.0.0.1",
                                         int(port or 0)))
        _initialized = True
        from .group import get_group
        get_group(0)     # the world's group (and its gloo side group)
    return ParallelEnv()


def _shutdown():
    """Tear the process group and the store down (``destroy_process_group``
    of the world)."""
    global _initialized, _store, _backend
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if _store is not None:
        _store.close()
    _store, _backend, _initialized = None, None, False


def _start_heartbeat(store, rank, rendezvous=None):
    """Elastic fault detection, worker half: a daemon thread bumps
    ``hb/<rank>`` every interval on a connection of its own (the
    launcher's heartbeat store when ``PADDLE_ELASTIC_HB_ENDPOINT`` names
    one, else the rendezvous store); the launcher restarts the job when a
    rank's beat stops."""
    import threading
    import time as _time

    from ..native.tcp_store import TCPStore

    hb = None
    hb_ep = os.environ.get("PADDLE_ELASTIC_HB_ENDPOINT")
    if hb_ep:
        try:
            h, _, p = hb_ep.partition(":")
            hb = TCPStore(host=h or "127.0.0.1", port=int(p),
                          is_master=False, timeout=10.0)
        except Exception:  # noqa: BLE001
            hb = None
    if hb is None and rendezvous is not None:
        try:
            hb = TCPStore(host=rendezvous[0], port=rendezvous[1],
                          is_master=False, timeout=10.0)
        except Exception:  # noqa: BLE001
            hb = None
    if hb is None:
        hb = store
    interval = float(os.environ.get(
        "PADDLE_ELASTIC_HEARTBEAT_INTERVAL", "2"))

    def beat():
        n = 0
        while True:
            try:
                hb.set(f"hb/{rank}", str(n))
            except Exception:  # noqa: BLE001 - store gone: stop quietly
                return
            n += 1
            _time.sleep(interval)

    threading.Thread(target=beat, daemon=True,
                     name=f"paddle-elastic-hb-{rank}").start()


class ParallelEnv:
    @property
    def rank(self):
        return global_rank()

    @property
    def local_rank(self):
        return local_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        return _env_int("FLAGS_selected_gpus", local_rank())

    @property
    def device(self) -> torch.device:
        return rank_device()

    @property
    def backend(self) -> Optional[str]:
        return _backend

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        r = self.rank
        return eps[r] if r < len(eps) else ""

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def is_initialized() -> bool:
    return _initialized


def parallel_device_count() -> int:
    """The CUDA devices visible to this process (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
