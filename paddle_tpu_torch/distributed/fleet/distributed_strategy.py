"""``DistributedStrategy``: the fleet's feature toggles, the port of
``paddle_tpu/distributed/fleet/distributed_strategy.py``.

A plain typed object with the reference's names and defaults. The toggles
the port does not implement yet (DGC, LocalSGD and its adaptive form,
pipeline parallelism, ZeRO sharding) are accepted here; ``fleet.init`` and
``fleet.distributed_optimizer`` refuse a strategy that turns one on
(``unported_features``), naming ROADMAP queue 1 item 5c, part 2. The
communication knobs (``fuse_all_reduce_ops``, NCCL settings, ...) are
recorded and change nothing.
"""
from __future__ import annotations

import copy
import json


_DEFAULT_CONFIGS = {
    "amp_configs": {
        "init_loss_scaling": 32768.0, "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0, "decr_ratio": 0.5,
        "use_dynamic_loss_scaling": True, "custom_white_list": [],
        "custom_black_list": [], "use_pure_fp16": False, "use_bf16": True,
        "use_fp16_guard": True,
    },
    "recompute_configs": {"checkpoints": [], "enable_offload": False,
                          "checkpoint_shape": []},
    "pipeline_configs": {"micro_batch_size": 1, "accumulate_steps": 1,
                         "schedule_mode": "1F1B", "p2p_cache_shape": True},
    "hybrid_configs": {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                       "sharding_degree": 1, "sep_degree": 1},
    "sharding_configs": {"sharding_segment_strategy": "segment_broadcast_MB",
                         "segment_broadcast_MB": 32, "sharding_degree": 8,
                         "mp_degree": 1, "stage": 1, "offload": False},
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd_configs": {"init_k_steps": 1, "begin_step": 1},
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0, "exclude_from_weight_decay": []},
    "lamb_configs": {"lamb_weight_decay": 0.01,
                     "exclude_from_weight_decay": []},
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 1,
                       "send_queue_size": 16,
                       "independent_recv_thread": False},
    "qat_configs": {"channel_wise_abs_max": True, "weight_bits": 8,
                    "activation_bits": 8, "not_quant_pattern": []},
    "tensor_parallel_configs": {"tensor_parallel_degree": 1,
                                "tensor_init_seed": -1},
}

_BOOL_TOGGLES = [
    "amp", "asp", "recompute", "sync_nccl_allreduce",
    "use_hierarchical_allreduce", "sync_batch_norm", "fuse_all_reduce_ops",
    "find_unused_parameters", "sharding", "without_graph_optimization",
    "fuse_grad_merge", "pipeline", "tensor_parallel", "localsgd",
    "adaptive_localsgd", "dgc", "gradient_merge", "lars", "lamb", "elastic",
    "auto", "semi_auto", "auto_search", "qat", "heter_ccl_mode", "a_sync",
    "fp16_allreduce", "adam_d2sum", "is_fl_ps_mode", "is_with_coordinator",
    "cudnn_exhaustive_search", "cudnn_batchnorm_spatial_persistent",
    "_calc_comm_same_stream", "split_data",
]

# inert numeric/str knobs accepted with reference defaults (the full
# property surface of distributed_strategy.py:117; recorded, they change
# nothing; the names must not AttributeError — SURVEY §2.6)
_SCALAR_DEFAULTS = {
    "nccl_comm_num": 1,
    "fuse_grad_size_in_MB": 32,
    "fuse_grad_size_in_num": 8,
    "last_comm_group_size_MB": 1,
    "_fuse_grad_size_in_TFLOPS": 50.0,
    "conv_workspace_size_limit": 512,
    "hierarchical_allreduce_inter_nranks": 1,
    "fs_client_param": None,
    "sparse_table_configs": None,
    "trainer_desc_configs": None,
    "gradient_scale_configs": {"scale_strategy": "avg"},
}


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_flags"] = {t: False for t in _BOOL_TOGGLES}
        self.__dict__["_configs"] = copy.deepcopy(_DEFAULT_CONFIGS)
        self.__dict__["_scalars"] = copy.deepcopy(_SCALAR_DEFAULTS)
        # execution/build strategy accepted for compat
        self.__dict__["execution_strategy"] = None
        self.__dict__["build_strategy"] = None

    def __getattr__(self, name):
        flags = self.__dict__["_flags"]
        configs = self.__dict__["_configs"]
        scalars = self.__dict__["_scalars"]
        if name in flags:
            return flags[name]
        if name in configs:
            return configs[name]
        if name in scalars:
            return scalars[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        flags = self.__dict__["_flags"]
        configs = self.__dict__["_configs"]
        scalars = self.__dict__["_scalars"]
        if name in flags:
            flags[name] = bool(value)
        elif name in configs:
            merged = dict(configs[name])
            merged.update(value or {})
            configs[name] = merged
        elif name in ("execution_strategy", "build_strategy"):
            self.__dict__[name] = value
        else:
            scalars[name] = value

    def unported_features(self) -> list:
        """The toggles on in this strategy whose training waits for part 2
        of item 5c: dgc, localsgd, adaptive_localsgd, pipeline (or a
        ``pp_degree`` above 1), sharding (or a ``sharding_degree`` above
        1)."""
        on = [t for t in ("dgc", "localsgd", "adaptive_localsgd",
                          "pipeline", "sharding") if self._flags[t]]
        hc = self._configs["hybrid_configs"]
        if int(hc.get("pp_degree", 1)) > 1 and "pipeline" not in on:
            on.append("pipeline")
        if int(hc.get("sharding_degree", 1)) > 1 and "sharding" not in on:
            on.append("sharding")
        return on

    def to_json(self):
        return json.dumps({"flags": self._flags, "configs": self._configs,
                           "scalars": {k: v for k, v in self._scalars.items()
                                       if isinstance(v, (int, float, str,
                                                         list, dict))}})

    def __repr__(self):
        on = [k for k, v in self._flags.items() if v]
        return f"DistributedStrategy(enabled={on})"
