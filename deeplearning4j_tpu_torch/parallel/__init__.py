"""Parallelism over ``torch.distributed`` (mirrors
``deeplearning4j_tpu/parallel/__init__.py`` as far as the port goes).

  reference ParallelWrapper / ParameterAveragingTrainingMaster
                                → ``ShardedTrainer`` with
    ``grad_compression=None``: one process per rank, the mean gradient by
    all-reduce every step (averagingFrequency=1); a ``model`` axis splits
    each leaf by the reference's ``_shard_leaf`` rule
  reference SharedTrainingMaster (threshold-compressed gradients with a
    residual, SharedTrainingMaster.java:55)
                                → ``ShardedTrainer(grad_compression=
    "threshold"|"bitmap")`` over ``build_two_tier_mesh``: dense all-reduce
    within a slice (``data``), the compressed exchange across slices
    (``dcn``) with each slice's error-feedback residual
    (``ops/compression.py``)
  the 4-D parallel TransformerLM → ``ShardedTransformerLM``: tensor
    (``model``), sequence (``seq``: ``ring_attention``,
    ``ulysses_attention``) and pipeline (``pipe``: ``pipeline_apply``,
    GPipe and 1F1B) parallelism, and its one-way and tensor-parallel
    decode programs; ``collectives`` holds the autograd collectives they
    run on

Not ported yet (ROADMAP queue 1 item 7): MoE, inference wrappers and
the elastic runtime (launcher, chaos, preemption).
"""

from .collectives import Axis
from .distributed import (detect_num_slices, initialize, is_coordinator,
                          local_batch_slice, process_count, process_index,
                          shutdown, validate_coordinator_address)
from .mesh import (RankMesh, build_mesh, build_two_tier_mesh, infer_param_shardings,
                   local_shard, shard_axis)
from .pipeline import (SCHEDULES, pipeline_apply, pipeline_schedule_stats,
                       stack_stage_params, stage_sharding)
from .ring import ring_attention, ring_self_attention
from .trainer import ShardedTrainer
from .transformer import ShardedTransformerLM
from .ulysses import ulysses_attention, ulysses_self_attention

__all__ = [
    "Axis", "RankMesh", "SCHEDULES", "ShardedTrainer", "ShardedTransformerLM",
    "build_mesh", "build_two_tier_mesh", "detect_num_slices", "infer_param_shardings",
    "initialize", "is_coordinator", "local_batch_slice", "local_shard",
    "pipeline_apply", "pipeline_schedule_stats", "process_count", "process_index",
    "ring_attention", "ring_self_attention", "shard_axis", "shutdown",
    "stack_stage_params", "stage_sharding", "ulysses_attention",
    "ulysses_self_attention", "validate_coordinator_address",
]
