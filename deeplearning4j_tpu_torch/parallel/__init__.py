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

  reference CheckpointListener + Spark task retry
                                → ``ElasticTrainer`` (checkpoint-restore
    recovery with backoff and jitter, the step watchdog, async
    checkpoints), chaos-tested by deterministic fault injection
    (``chaos``) and announced preemption (``preemption``)
  the reference's cluster entry point → the pod launcher (``launcher``
    and the CLI's ``launch``): worker processes with heartbeat
    membership epochs, relaunch on leave, process-kill chaos, planned
    leaves that do not spend the restart budget
  Mixture-of-Experts with expert parallelism → ``moe``
  ParallelInference → a shim over one ``serving.Engine``
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

from .chaos import (ChaosInjector, FaultKind, FaultSchedule, FleetChaos, ServingChaos,
                    bitflip_file, truncate_file)
from .distributed import (PREEMPTED_EXIT_CODE, CoordinatorUnreachableError,
                          probe_multiprocess_support, reinitialize, resolve_process_index)
from .elastic import (CheckpointManager, ElasticTrainer, FailureDetector,
                      RecoverableInfraError, StepHangError)
from .inference import ParallelInference
from .launcher import (Heartbeat, HostLostError, Membership, MembershipChangedError,
                       PodLauncher, ProcessFailureDetector, elect_coordinator,
                       maybe_bootstrap_from_env)
from .mesh import surviving_mesh
from .moe import MoE, init_moe_params, moe_forward_dense, moe_forward_ep
from .preemption import PreemptedError, PreemptionHandler

__all__ = [
    "Axis", "ChaosInjector", "CheckpointManager", "CoordinatorUnreachableError",
    "ElasticTrainer", "FailureDetector", "FaultKind", "FaultSchedule", "FleetChaos",
    "Heartbeat", "HostLostError", "Membership", "MembershipChangedError", "MoE",
    "PREEMPTED_EXIT_CODE", "ParallelInference", "PodLauncher", "PreemptedError",
    "PreemptionHandler", "ProcessFailureDetector", "RankMesh", "RecoverableInfraError",
    "SCHEDULES", "ServingChaos", "ShardedTrainer", "ShardedTransformerLM",
    "StepHangError", "bitflip_file", "build_mesh", "build_two_tier_mesh",
    "detect_num_slices", "elect_coordinator", "infer_param_shardings", "init_moe_params",
    "initialize", "is_coordinator", "local_batch_slice", "local_shard",
    "maybe_bootstrap_from_env", "moe_forward_dense", "moe_forward_ep",
    "pipeline_apply", "pipeline_schedule_stats", "probe_multiprocess_support",
    "process_count", "process_index", "reinitialize", "resolve_process_index",
    "ring_attention", "ring_self_attention", "shard_axis", "shutdown",
    "stack_stage_params", "stage_sharding", "surviving_mesh", "truncate_file",
    "ulysses_attention", "ulysses_self_attention", "validate_coordinator_address",
]
