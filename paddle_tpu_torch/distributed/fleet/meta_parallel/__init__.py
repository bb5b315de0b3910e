"""``fleet.meta_parallel`` of the port: the tensor-parallel layers (their
collectives are explicit in their forwards). Pipeline parallelism (``PipelineLayer``, ``LayerDesc``,
``PipelineParallel``), ZeRO (``group_sharded_parallel``, the
``GroupSharded*`` classes), ``HybridParallelOptimizer`` and DGC/LocalSGD
wait for ROADMAP queue 1 item 5c, part 2: their names raise naming it."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding,
                        get_rng_state_tracker, mark_megatron)
from ..._part2 import part2

PipelineLayer = part2("fleet.meta_parallel.PipelineLayer")
LayerDesc = part2("fleet.meta_parallel.LayerDesc")
SharedLayerDesc = part2("fleet.meta_parallel.SharedLayerDesc")
SegmentLayers = part2("fleet.meta_parallel.SegmentLayers")
PipelineParallel = part2("fleet.meta_parallel.PipelineParallel")
PipelineParallelWithInterleave = part2(
    "fleet.meta_parallel.PipelineParallelWithInterleave")
GroupShardedStage2 = part2("fleet.meta_parallel.GroupShardedStage2")
GroupShardedStage3 = part2("fleet.meta_parallel.GroupShardedStage3")
GroupShardedOptimizerStage2 = part2(
    "fleet.meta_parallel.GroupShardedOptimizerStage2")
group_sharded_parallel = part2("group_sharded_parallel")
save_group_sharded_model = part2("save_group_sharded_model")
HybridParallelOptimizer = part2("fleet.meta_parallel.HybridParallelOptimizer")
HybridParallelGradScaler = part2(
    "fleet.meta_parallel.HybridParallelGradScaler")
DGCMomentum = part2("fleet.meta_parallel.DGCMomentum")
make_localsgd_optimizer = part2("fleet.meta_parallel.make_localsgd_optimizer")

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mark_megatron",
           "get_rng_state_tracker"]
