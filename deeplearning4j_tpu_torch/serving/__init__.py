from .batcher import (ADMISSION_POLICIES, ContinuousBatcher, DeadlineExceededError,
                      DynamicBatcher, OverloadedError, pow2_buckets)
from .decode import DecodeEngine, GenerationResult
from .engine import (Engine, ModelNotLoadedError, PoisonInputError, ReplicaCrashError,
                     ReplicaHungError, ServingUnavailableError)
from .metrics import DecodeMetrics, LatencyHistogram, ServingMetrics
from .registry import ModelRegistry

__all__ = ["ADMISSION_POLICIES", "ContinuousBatcher", "DeadlineExceededError",
           "DecodeEngine", "DecodeMetrics", "DynamicBatcher", "Engine",
           "GenerationResult", "LatencyHistogram", "ModelNotLoadedError",
           "ModelRegistry", "OverloadedError", "PoisonInputError",
           "ReplicaCrashError", "ReplicaHungError", "ServingMetrics",
           "ServingUnavailableError", "pow2_buckets"]
