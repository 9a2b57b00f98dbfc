"""Serving in PyTorch (counterpart of ``shuffle_exchange_tpu.inference``
for the names the port has): the paged continuous-batching engine with
its scheduler, its sequential ``put`` / ``decode_loop`` API and its
multi-tenant LoRA adapter pool, and the dense-cache v1 engine
(``init_inference(...).generate``)."""

from .adapters import AdapterPool, AdapterPoolDry
from .config import AdapterConfig, InferenceConfig, MoEServingConfig, ServingConfig
from .engine import InferenceEngine, KVCache, init_inference
from .engine_v2 import InferenceEngineV2, SequenceDescriptor
from .paged import BlockedAllocator, PagedKVCache
from .scheduler import ContinuousBatchingScheduler, ServingRequest

__all__ = [
    "InferenceConfig",
    "ServingConfig",
    "MoEServingConfig",
    "AdapterConfig",
    "AdapterPool",
    "AdapterPoolDry",
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
