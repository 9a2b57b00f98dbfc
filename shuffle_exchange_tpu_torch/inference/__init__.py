"""Serving in PyTorch (counterpart of ``shuffle_exchange_tpu.inference``
for the names the port has): the paged continuous-batching engine with
its scheduler and its sequential ``put`` / ``decode_loop`` API, and the
dense-cache v1 engine (``init_inference(...).generate``)."""

from .config import InferenceConfig, MoEServingConfig, ServingConfig
from .engine import InferenceEngine, KVCache, init_inference
from .engine_v2 import InferenceEngineV2, SequenceDescriptor
from .paged import BlockedAllocator, PagedKVCache
from .scheduler import ContinuousBatchingScheduler, ServingRequest

__all__ = [
    "InferenceConfig",
    "ServingConfig",
    "MoEServingConfig",
    "InferenceEngine",
    "KVCache",
    "init_inference",
    "BlockedAllocator",
    "PagedKVCache",
    "InferenceEngineV2",
    "SequenceDescriptor",
    "ContinuousBatchingScheduler",
    "ServingRequest",
]
