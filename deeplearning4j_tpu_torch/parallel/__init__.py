"""Parallelism over ``torch.distributed`` (mirrors
``deeplearning4j_tpu/parallel/__init__.py`` as far as the port goes).

  reference ParallelWrapper / ParameterAveragingTrainingMaster
                                → ``ShardedTrainer`` with
    ``grad_compression=None``: one process per rank, the mean gradient by
    all-reduce every step (averagingFrequency=1)
  reference SharedTrainingMaster (threshold-compressed gradients with a
    residual, SharedTrainingMaster.java:55)
                                → ``ShardedTrainer(grad_compression=
    "threshold"|"bitmap")`` over ``build_two_tier_mesh``: dense all-reduce
    within a slice (``data``), the compressed exchange across slices
    (``dcn``) with each slice's error-feedback residual
    (``ops/compression.py``)

Not ported yet (ROADMAP queue 9): tensor, sequence and pipeline
parallelism, MoE, the sharded TransformerLM, inference wrappers and the
elastic runtime (launcher, chaos, preemption).
"""

from .distributed import (detect_num_slices, initialize, is_coordinator,
                          local_batch_slice, process_count, process_index,
                          shutdown, validate_coordinator_address)
from .mesh import RankMesh, build_mesh, build_two_tier_mesh
from .trainer import ShardedTrainer

__all__ = [
    "RankMesh", "ShardedTrainer", "build_mesh", "build_two_tier_mesh",
    "detect_num_slices", "initialize", "is_coordinator", "local_batch_slice",
    "process_count", "process_index", "shutdown", "validate_coordinator_address",
]
