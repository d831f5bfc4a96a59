from .autoscale import ReplicaAutoscaler
from .batcher import (ADMISSION_POLICIES, ContinuousBatcher, DeadlineExceededError,
                      DynamicBatcher, OverloadedError, pow2_buckets)
from .decode import DecodeEngine, GenerationResult
from .engine import (Engine, ModelNotLoadedError, PoisonInputError, ReplicaCrashError,
                     ReplicaHungError, ServingUnavailableError)
from .metrics import DecodeMetrics, LatencyHistogram, ServingMetrics
from .registry import CanaryRejectedError, ModelRegistry
from .tenancy import TenantConfig, TenantOverloadedError, TenantTable
from . import warmcache

__all__ = ["ADMISSION_POLICIES", "CanaryRejectedError", "ContinuousBatcher",
           "DeadlineExceededError", "DecodeEngine", "DecodeMetrics",
           "DynamicBatcher", "Engine", "GenerationResult", "LatencyHistogram",
           "ModelNotLoadedError", "ModelRegistry", "OverloadedError",
           "PoisonInputError", "ReplicaAutoscaler", "ReplicaCrashError",
           "ReplicaHungError", "ServingMetrics", "ServingUnavailableError",
           "TenantConfig", "TenantOverloadedError", "TenantTable",
           "pow2_buckets", "warmcache"]
