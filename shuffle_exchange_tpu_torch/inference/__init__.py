"""Paged continuous-batching serving, in PyTorch (counterpart of
``shuffle_exchange_tpu.inference`` for the names this slice ports)."""

from .config import InferenceConfig, ServingConfig
from .engine import InferenceEngine
from .engine_v2 import InferenceEngineV2, SequenceDescriptor
from .paged import BlockedAllocator, PagedKVCache
from .scheduler import ContinuousBatchingScheduler, ServingRequest

__all__ = [
    "InferenceConfig",
    "ServingConfig",
    "InferenceEngine",
    "BlockedAllocator",
    "PagedKVCache",
    "InferenceEngineV2",
    "SequenceDescriptor",
    "ContinuousBatchingScheduler",
    "ServingRequest",
]
