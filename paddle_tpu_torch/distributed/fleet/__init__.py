"""``paddle.distributed.fleet`` of the port: ``fleet.init`` and the
topology, ``DistributedStrategy``, ``distributed_model``/
``distributed_optimizer``, the worker queries, the role makers,
``meta_parallel`` (the tensor-parallel layers) and ``utils.recompute``.
The data generators (``util_data``) and the elastic manager wait for
ROADMAP queue 1 item 5c, part 2: their names raise naming it."""
from . import distributed_strategy, fleet_api, meta_parallel  # noqa: F401
from . import topology, utils  # noqa: F401
from .utils import recompute  # noqa: F401
from .._part2 import part2
from ..env import ParallelEnv
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_api import (  # noqa: F401
    barrier_worker, distributed_model, distributed_optimizer,
    get_hybrid_communicate_group, init, is_first_worker, is_initialized,
    save_inference_model, save_persistables, worker_index, worker_num,
)
from .fleet_api import _FleetAPIType as Fleet  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401

util_data = part2("fleet.util_data")
DataGenerator = part2("fleet.DataGenerator")
MultiSlotDataGenerator = part2("fleet.MultiSlotDataGenerator")
MultiSlotStringDataGenerator = part2("fleet.MultiSlotStringDataGenerator")
Role = part2("fleet.Role")
UtilBase = part2("fleet.UtilBase")
elastic = part2("fleet.elastic")


class PaddleCloudRoleMaker:
    """The collective role maker: this rank's role, index and peers read
    from the launcher's environment (``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``)."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        self._env = ParallelEnv()

    def _worker_index(self):
        return self._env.rank

    def _worker_num(self):
        return self._env.world_size

    def _is_worker(self):
        return True

    def _is_first_worker(self):
        return self._env.rank == 0

    def _get_trainer_endpoints(self):
        return self._env.trainer_endpoints


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """A role maker whose rank and world come from its arguments."""

    def __init__(self, is_collective=True, current_id=0, worker_num=1,
                 worker_endpoints=None, **kwargs):
        super().__init__(is_collective)
        self._id = int(current_id)
        self._num = int(worker_num)
        self._endpoints = list(worker_endpoints or [])

    def _worker_index(self):
        return self._id

    def _worker_num(self):
        return self._num

    def _is_first_worker(self):
        return self._id == 0

    def _get_trainer_endpoints(self):
        return self._endpoints
