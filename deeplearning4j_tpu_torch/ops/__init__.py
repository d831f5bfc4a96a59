"""Tensor ops of the port (mirrors ``deeplearning4j_tpu/ops``)."""

from .dtypes import DTypePolicy, canonical_dtype, default_policy, mixed_policy
from .initializers import WeightInit, init_weight
