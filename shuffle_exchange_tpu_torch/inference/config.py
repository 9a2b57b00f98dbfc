"""Inference config of the PyTorch port.

Counterpart of ``shuffle_exchange_tpu/inference/config.py`` for the fields
the paged continuous-batching slice runs on, with the JAX package's
defaults and validation. Keys of features this slice does not port raise a
``ConfigError`` naming the ROADMAP item that will; nothing is ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..config.config_utils import ConfigError

_DTYPES = {"bf16": "bfloat16", "bfloat16": "bfloat16", "fp16": "float16",
           "float16": "float16", "fp32": "float32", "float32": "float32"}

#: keys of the JAX config this slice does not port, and where they go
_UNSUPPORTED = {
    "speculative": "speculative decoding (ROADMAP queue A, item 3)",
    "sampling": "seeded sampling and stop conditions (ROADMAP queue A, item 3)",
    "seed": "the sampling seed; this slice decodes greedily (ROADMAP queue A, item 3)",
    "kv_tier": "the host KV tier (ROADMAP queue A, item 3)",
    "prefix_caching": "prefix caching (ROADMAP queue A, item 3)",
    "kv_cache_dtype": "int8/fp8 KV storage (ROADMAP queue A, item 3)",
    "adapters": "multi-tenant LoRA adapters (ROADMAP queue A, item 10)",
    "moe": "MoE serving (ROADMAP queue A, item 9)",
    "router": "the multi-replica router (ROADMAP queue A, item 13)",
}


def _refuse(key: str) -> ConfigError:
    return ConfigError(f"{key!r}: {_UNSUPPORTED[key]} is not in the PyTorch "
                       "port yet")


@dataclasses.dataclass
class ServingConfig:
    """Continuous-batching scheduler knobs: ``token_budget`` tokens per
    tick (one per running sequence, the rest prefill chunks), at most
    ``max_running`` running sequences, ``chunk_min`` the smallest partial
    prefill chunk worth a slot, ``chunk_bins`` the padded chunk ladder
    (None derives chunk_min * 2^k capped at token_budget)."""

    token_budget: int = 256
    max_running: int = 8
    chunk_min: int = 16
    chunk_bins: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.token_budget < 1:
            raise ConfigError(f"serving.token_budget must be >= 1, got "
                              f"{self.token_budget}")
        if not 1 <= self.max_running <= self.token_budget:
            raise ConfigError(
                f"serving.max_running must be in [1, token_budget="
                f"{self.token_budget}] (every running sequence takes one "
                f"budget slot per tick), got {self.max_running}")
        if not 1 <= self.chunk_min <= self.token_budget:
            raise ConfigError(
                f"serving.chunk_min must be in [1, token_budget="
                f"{self.token_budget}], got {self.chunk_min}")
        if self.chunk_bins is not None:
            try:
                bins = tuple(sorted({int(c) for c in self.chunk_bins}))
            except (TypeError, ValueError) as e:
                raise ConfigError(f"serving.chunk_bins must be a list of "
                                  f"ints: {e}") from e
            if not bins or bins[0] < 1:
                raise ConfigError(f"serving.chunk_bins must be positive ints, "
                                  f"got {self.chunk_bins!r}")
            self.chunk_bins = bins

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingConfig":
        d = dict(d)
        for key in ("speculative", "moe"):
            if key in d:
                raise _refuse(key)
        allowed = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - allowed
        if unknown:
            raise ConfigError(f"unknown serving config keys {sorted(unknown)} "
                              f"(allowed: {sorted(allowed)})")
        return cls(**d)

    def bins(self) -> Tuple[int, ...]:
        """The padded chunk-size ladder (ascending)."""
        if self.chunk_bins:
            return self.chunk_bins
        out, b = [], self.chunk_min
        while b < self.token_budget:
            out.append(b)
            b *= 2
        out.append(self.token_budget)
        return tuple(dict.fromkeys(out))

    def bin_chunk(self, c: int) -> int:
        """Smallest ladder bin >= c (chunks past the ladder round up to the
        next power of two)."""
        for b in self.bins():
            if c <= b:
                return b
        out = self.bins()[-1]
        while out < c:
            out *= 2
        return out


@dataclasses.dataclass
class InferenceConfig:
    dtype: str = "bfloat16"
    max_batch_size: int = 8
    max_seq_len: int = 2048
    # "auto" | "xla" | "pallas": "pallas" runs decode rows through the
    # fused decode kernels (QKV+RoPE+append, split-K attention, fused MLP;
    # their plain versions on a CPU engine), "xla" through the layer body
    # over the paged decode kernel; "auto" is "pallas" on the card and
    # "xla" on the CPU
    decode_kernel: str = "auto"
    kv_block_size: int = 64
    num_kv_blocks: int = 256
    # only the default bf16 storage (the serving dtype) is ported
    kv_cache_dtype: str = "bf16"
    prefix_caching: bool = False
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)

    def __post_init__(self):
        if self.serving is None:
            self.serving = ServingConfig()
        elif isinstance(self.serving, dict):
            self.serving = ServingConfig.from_dict(self.serving)
        elif not isinstance(self.serving, ServingConfig):
            raise ConfigError(f"serving must be a dict or ServingConfig, got "
                              f"{type(self.serving).__name__}")
        key = str(self.dtype).replace("torch.", "")
        if key not in _DTYPES:
            raise ConfigError(f"unsupported inference dtype {self.dtype!r}")
        self.dtype = _DTYPES[key]
        if self.decode_kernel not in ("auto", "pallas", "xla"):
            raise ConfigError(f'decode_kernel must be "auto", "pallas" or '
                              f'"xla", got {self.decode_kernel!r}')
        if str(self.kv_cache_dtype).strip().lower() not in ("bf16", "bfloat16"):
            raise _refuse("kv_cache_dtype")
        self.kv_cache_dtype = "bf16"
        if not isinstance(self.prefix_caching, bool):
            raise ConfigError(f"prefix_caching must be a bool, got "
                              f"{self.prefix_caching!r}")
        if self.prefix_caching:
            raise _refuse("prefix_caching")
        for name in ("max_batch_size", "max_seq_len", "kv_block_size", "num_kv_blocks"):
            if int(getattr(self, name)) < 1:
                raise ConfigError(f"{name} must be >= 1, got {getattr(self, name)}")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "InferenceConfig":
        """Build from a JAX-format config dict. Keys of features this slice
        does not port raise, naming the ROADMAP item; other unknown keys
        raise too."""
        d = dict(d or {})
        for key in _UNSUPPORTED:
            if key in ("kv_cache_dtype", "prefix_caching", "moe"):
                continue   # validated by value below / inside serving
            if key in d:
                raise _refuse(key)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ConfigError(f"inference config keys {sorted(unknown)} are not "
                              f"supported by the PyTorch port (known: "
                              f"{sorted(known)})")
        return cls(**d)

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
