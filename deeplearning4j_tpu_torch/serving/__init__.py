from .autoscale import ReplicaAutoscaler
from .batcher import (ADMISSION_POLICIES, ContinuousBatcher, DeadlineExceededError,
                      DynamicBatcher, OverloadedError, pow2_buckets)
from .decode import DecodeEngine, GenerationResult, PrefillHandoff
from .engine import (Engine, ModelNotLoadedError, PoisonInputError, ReplicaCrashError,
                     ReplicaHungError, ServingUnavailableError)
from .fleet import FleetHost, FleetRouter, FleetTimeoutError, HttpHost
from .metrics import DecodeMetrics, FleetMetrics, LatencyHistogram, ServingMetrics
from .placement import PlacementController
from .registry import CanaryRejectedError, ModelRegistry
from .tenancy import TenantConfig, TenantOverloadedError, TenantTable
from . import warmcache
from .warmcache import (bundle_path_for, device_fingerprint, enable_compile_cache,
                        load_bundle, save_bundle)

__all__ = ["ADMISSION_POLICIES", "CanaryRejectedError", "ContinuousBatcher",
           "DeadlineExceededError", "DecodeEngine", "DecodeMetrics",
           "DynamicBatcher", "Engine", "FleetHost", "FleetMetrics", "FleetRouter",
           "FleetTimeoutError", "GenerationResult", "HttpHost", "LatencyHistogram",
           "ModelNotLoadedError", "ModelRegistry", "OverloadedError",
           "PlacementController", "PoisonInputError", "PrefillHandoff",
           "ReplicaAutoscaler", "ReplicaCrashError", "ReplicaHungError",
           "ServingMetrics", "ServingUnavailableError", "TenantConfig",
           "TenantOverloadedError", "TenantTable", "bundle_path_for",
           "device_fingerprint", "enable_compile_cache", "load_bundle",
           "pow2_buckets", "save_bundle"]
