"""``fleet.init``, ``distributed_model``, ``distributed_optimizer`` and the
worker queries: the port of ``paddle_tpu/distributed/fleet/fleet_api.py``.

``init`` reads ``strategy.hybrid_configs``, builds the topology and its
groups (``topology.py``) and initializes the process group
(``env.init_parallel_env``). ``distributed_model`` wraps a model in
``DataParallel`` over the data-parallel group when that group has more than
one rank (the reference leaves the averaging to the mesh; here it is the
eager collectives'). A strategy that turns on DGC, LocalSGD, pipeline
parallelism or ZeRO sharding raises in ``init`` and in
``distributed_optimizer``, naming ROADMAP queue 1 item 5c, part 2;
``lars`` swaps a ``Momentum`` for ``LarsMomentum`` as the reference's.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

from .. import env
from .._part2 import PART2
from .distributed_strategy import DistributedStrategy
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["init", "get_hybrid_communicate_group", "is_initialized",
           "distributed_model", "distributed_optimizer", "worker_index",
           "worker_num", "is_first_worker", "barrier_worker",
           "save_persistables", "save_inference_model"]

_fleet_state = {
    "initialized": False,
    "strategy": None,
    "hcg": None,
}


def _refuse_unported(strategy: Optional[DistributedStrategy]):
    if strategy is None:
        return
    on = strategy.unported_features()
    if on:
        raise NotImplementedError(
            f"DistributedStrategy turns on {', '.join(on)}: their training "
            f"waits for {PART2}")


def init(role_maker=None, is_collective=False,
         strategy: Optional[DistributedStrategy] = None):
    strategy = strategy or DistributedStrategy()
    _refuse_unported(strategy)
    env.init_parallel_env()
    hc = strategy.hybrid_configs
    dims = [hc.get("dp_degree", 1), hc.get("pp_degree", 1),
            hc.get("sharding_degree", 1), hc.get("mp_degree", 1)]
    names = ["data", "pipe", "sharding", "model"]
    if hc.get("sep_degree", 1) > 1:
        dims.insert(3, hc["sep_degree"])
        names.insert(3, "sep")
    if hc.get("ep_degree", 1) > 1:
        dims.insert(3, hc["ep_degree"])
        names.insert(3, "expert")
    topo = CommunicateTopology(names, dims)
    hcg = HybridCommunicateGroup(topo)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)
    return _FleetAPI


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _fleet_state["hcg"]


def is_initialized():
    return _fleet_state["initialized"]


def distributed_model(model):
    """``DataParallel`` over the data-parallel group when it has several
    ranks; the model itself otherwise (tagged with the topology)."""
    hcg = _fleet_state["hcg"]
    if hcg is None:
        return model
    if hcg.get_pipe_parallel_world_size() > 1:
        raise NotImplementedError(
            f"fleet.distributed_model under pipeline parallelism waits for "
            f"{PART2}")
    dp = hcg.get_data_parallel_group()
    if dp.nranks > 1:
        from ..parallel import DataParallel
        model = DataParallel(model, group=dp)
    model._fleet_hcg = hcg
    return model


def _apply_lars(optimizer, strategy):
    if not getattr(strategy, "lars", False):
        return optimizer
    from ...optimizer import LarsMomentum, Momentum
    if isinstance(optimizer, LarsMomentum):
        return optimizer
    if not isinstance(optimizer, Momentum):
        warnings.warn(
            "DistributedStrategy.lars applies to a Momentum optimizer "
            f"(reference lars_optimizer.py contract); got "
            f"{type(optimizer).__name__}: running it unchanged")
        return optimizer
    cfg = strategy.lars_configs or {}
    return LarsMomentum(
        learning_rate=optimizer._lr, momentum=optimizer._momentum,
        lars_coeff=cfg.get("lars_coeff", 0.001),
        lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
        parameters=optimizer._parameters, grad_clip=optimizer._grad_clip,
        exclude_from_weight_decay=cfg.get("exclude_from_weight_decay", []),
        epsilon=cfg.get("epsilon", 0.0))


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer under the strategy's meta-optimizers (``lars``); the
    data-parallel gradients are averaged by ``distributed_model``'s
    ``DataParallel``, so the optimizer steps as it is."""
    strategy = strategy or _fleet_state["strategy"]
    _refuse_unported(strategy)
    if strategy is not None:
        optimizer = _apply_lars(optimizer, strategy)
    return optimizer


def worker_index():
    return env.global_rank()


def worker_num():
    return env.get_world_size()


def is_first_worker():
    return env.global_rank() == 0


def barrier_worker():
    from ..communication.collective import barrier
    barrier()


def save_persistables(executor=None, dirname=None, main_program=None, **kw):
    """Save ``main_program``'s (a layer's) state dict under ``dirname`` as
    ``persistables.pdparams``."""
    from ...framework.io import save
    if main_program is None or not hasattr(main_program, "state_dict"):
        raise TypeError("save_persistables needs main_program: a layer "
                        "with state_dict()")
    os.makedirs(dirname or ".", exist_ok=True)
    save(main_program.state_dict(),
         os.path.join(dirname or ".", "persistables.pdparams"))


def save_inference_model(executor=None, dirname=None, feeded_var_names=None,
                         target_vars=None, main_program=None,
                         input_spec=None, **kw):
    """Export ``main_program`` (a layer) for inference under ``dirname``
    (``model.pt2``, through ``jit.save`` with ``input_spec``)."""
    from ...jit import save
    if main_program is None:
        raise TypeError("save_inference_model needs main_program: the "
                        "layer to export")
    os.makedirs(dirname or ".", exist_ok=True)
    return save(main_program, os.path.join(dirname or ".", "model"),
                input_spec=input_spec)


class _FleetAPIType:
    init = staticmethod(init)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    is_first_worker = staticmethod(is_first_worker)
    barrier_worker = staticmethod(barrier_worker)
    save_persistables = staticmethod(save_persistables)
    save_inference_model = staticmethod(save_inference_model)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)
    is_initialized = staticmethod(is_initialized)
    DistributedStrategy = DistributedStrategy

    @property
    def worker_endpoints(self):
        return env.ParallelEnv().trainer_endpoints


_FleetAPI = _FleetAPIType()
