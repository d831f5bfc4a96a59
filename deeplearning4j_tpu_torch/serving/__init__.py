from .autoscale import ReplicaAutoscaler
from .batcher import (ADMISSION_POLICIES, ContinuousBatcher, DeadlineExceededError,
                      DynamicBatcher, OverloadedError, pow2_buckets)
from .decode import DecodeEngine, GenerationResult, PrefillHandoff
from .engine import (Engine, ModelNotLoadedError, PoisonInputError, ReplicaCrashError,
                     ReplicaHungError, ServingUnavailableError)
from .fleet import FleetHost, FleetRouter, FleetTimeoutError, HttpHost
from .lifecycle import (EvalGate, PipelineJournal, PipelineStageError, PromotionPipeline,
                        StageDeadlineError, data_fingerprint, weights_sha)
from .metrics import DecodeMetrics, FleetMetrics, LatencyHistogram, ServingMetrics
from .placement import PlacementController
from .registry import CanaryRejectedError, ModelRegistry
from .tenancy import TenantConfig, TenantOverloadedError, TenantTable
from . import warmcache
from .warmcache import (bundle_path_for, device_fingerprint, enable_compile_cache,
                        load_bundle, save_bundle)

__all__ = ["ADMISSION_POLICIES", "CanaryRejectedError", "ContinuousBatcher",
           "DeadlineExceededError", "DecodeEngine", "DecodeMetrics", "DynamicBatcher",
           "Engine", "EvalGate", "FleetHost", "FleetMetrics", "FleetRouter",
           "FleetTimeoutError", "GenerationResult", "HttpHost", "LatencyHistogram",
           "ModelNotLoadedError", "ModelRegistry", "OverloadedError", "PipelineJournal",
           "PipelineStageError", "PlacementController", "PoisonInputError",
           "PrefillHandoff", "PromotionPipeline", "ReplicaAutoscaler",
           "ReplicaCrashError", "ReplicaHungError", "ServingMetrics",
           "ServingUnavailableError", "StageDeadlineError", "TenantConfig",
           "TenantOverloadedError", "TenantTable", "bundle_path_for", "data_fingerprint",
           "device_fingerprint", "enable_compile_cache", "load_bundle", "pow2_buckets",
           "save_bundle", "weights_sha"]
