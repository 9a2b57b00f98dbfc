"""Inference config of the PyTorch port.

Counterpart of ``shuffle_exchange_tpu/inference/config.py`` for the fields
the paged continuous-batching engine and the dense-cache v1 ``generate``
run on, with the JAX package's defaults and validation. Keys and values of
features the port does not have yet raise a ``ConfigError`` naming the
ROADMAP item that will bring them; nothing is ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..config.config_utils import ConfigError

_DTYPES = {"bf16": "bfloat16", "bfloat16": "bfloat16", "fp16": "float16",
           "float16": "float16", "fp32": "float32", "float32": "float32"}

_KV_CACHE_DTYPES = {"bf16": "bf16", "bfloat16": "bf16", "int8": "int8",
                    "fp8": "fp8", "float8": "fp8", "e4m3": "fp8"}


def _normalize_kv_cache_dtype(value) -> str:
    """"bf16", "int8" or "fp8" from the spellings the JAX config takes."""
    key = str(value).strip().lower()
    if key not in _KV_CACHE_DTYPES:
        raise ConfigError(f'kv_cache_dtype must be "bf16", "int8" or "fp8", got {value!r}')
    return _KV_CACHE_DTYPES[key]

#: keys of the JAX config this slice does not port, and where they go
_UNSUPPORTED = {
    "speculative": "speculative decoding (ROADMAP queue A, item 3)",
    "sampling": "seeded sampling and stop conditions (ROADMAP queue A, item 3)",
    "seed": "the sampling seed; this slice decodes greedily (ROADMAP queue A, item 3)",
    "kv_tier": "the host KV tier (ROADMAP queue A, item 3)",
    "prefix_caching": "prefix caching (ROADMAP queue A, item 3 (b))",
    "router": "the multi-replica router (ROADMAP queue A, item 13)",
}


def sampling_knobs(temperature, top_k, top_p) -> str:
    """The sampling settings that ask for more than greedy decoding, named
    (empty when all three are at their greedy values)."""
    out = []
    if temperature is not None and float(temperature) > 0:
        out.append(f"temperature={temperature}")
    if top_k is not None and int(top_k) > 0:
        out.append(f"top_k={top_k}")
    if top_p is not None and float(top_p) < 1:
        out.append(f"top_p={top_p}")
    return ", ".join(out)


def _normalize_quant_bits(qb):
    """8, 4 or "fp8" from the spellings the JAX config takes ("FP8 ", "4",
    4.0); anything else is a ConfigError naming quant_bits."""
    if str(qb).strip().lower() == "fp8":
        return "fp8"
    try:
        qb_int = int(qb)
    except (TypeError, ValueError):
        qb_int = None
    if qb_int not in (8, 4):
        raise ConfigError(f"quant_bits must be 8, 4 or \"fp8\", got {qb!r}")
    return qb_int


def _refuse(key: str) -> ConfigError:
    return ConfigError(f"{key!r}: {_UNSUPPORTED[key]} is not in the PyTorch "
                       "port yet")


@dataclasses.dataclass
class AdapterConfig:
    """Multi-tenant LoRA serving, with the JAX package's defaults and
    validation: a fixed-slot device pool of rank-padded adapter factor
    pairs (``inference/adapters.py``) that a mixed-adapter batch gathers
    from per row inside the serving step.

    - ``slots``: resident adapters (the device planes carry slots + 1;
      slot 0 is the all-zeros null adapter no-adapter rows gather);
    - ``max_rank``: the rank ceiling; factors are zero-padded to it;
    - ``targets``: the attention projections adapted;
    - ``prefetch_depth``: adapters staged into pinned host buffers ahead
      of their expected acquire (0 disables staging).
    """

    enabled: bool = False
    slots: int = 4
    max_rank: int = 8
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    prefetch_depth: int = 1

    def __post_init__(self):
        if not isinstance(self.enabled, bool):
            raise ConfigError(f"adapters.enabled must be a bool, got {self.enabled!r}")
        for name in ("slots", "max_rank"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ConfigError(f"adapters.{name} must be an int >= 1, got {v!r}")
        if not isinstance(self.prefetch_depth, int) or self.prefetch_depth < 0:
            raise ConfigError(f"adapters.prefetch_depth must be an int >= 0 (0 disables "
                              f"prefetch staging), got {self.prefetch_depth!r}")
        self.targets = tuple(self.targets)
        supported = ("wq", "wk", "wv", "wo")
        bad = [t for t in self.targets if t not in supported]
        if bad or not self.targets:
            raise ConfigError(f"adapters.targets must be a non-empty subset of {supported}, "
                              f"got {self.targets!r}")


@dataclasses.dataclass
class MoEServingConfig:
    """Expert-capacity serving knobs, with the JAX package's defaults and
    validation:

    - ``capacity_factor``: per-expert buffer slack of the capacity routes
      and the admission pressure bar (overrides the model config's
      ``capacity_factor`` inside the serving engine only);
    - ``moe_impl``: "auto" defers to the model config's ``moe_impl``
      (whose "auto" is the capacity route, as JAX resolves it under its
      scanned layer stack); "ragged" is the dropless route whose tokens do
      not depend on the batch;
    - ``overload_policy``: "park" holds queued requests at their FIFO seat
      while the previous tick's peak expert load is over
      ``overload_threshold`` times its capacity; "drop" admits anyway and
      lets the capacity route drop the overflow.
    """

    capacity_factor: float = 1.25
    moe_impl: str = "auto"
    overload_policy: str = "park"
    overload_threshold: float = 1.0

    def __post_init__(self):
        self.capacity_factor = float(self.capacity_factor)
        if not self.capacity_factor > 0:
            raise ConfigError(f"serving.moe.capacity_factor must be > 0, got "
                              f"{self.capacity_factor!r}")
        allowed = ("auto", "capacity", "capacity_einsum", "ragged")
        if self.moe_impl not in allowed:
            raise ConfigError(f"serving.moe.moe_impl must be one of {allowed}, got "
                              f"{self.moe_impl!r}")
        if self.overload_policy not in ("park", "drop"):
            raise ConfigError(f"serving.moe.overload_policy must be 'park' or 'drop', got "
                              f"{self.overload_policy!r}")
        self.overload_threshold = float(self.overload_threshold)
        if not self.overload_threshold > 0:
            raise ConfigError(f"serving.moe.overload_threshold must be > 0, got "
                              f"{self.overload_threshold!r}")


@dataclasses.dataclass
class ServingConfig:
    """Continuous-batching scheduler knobs: ``token_budget`` tokens per
    tick (one per running sequence, the rest prefill chunks), at most
    ``max_running`` running sequences, ``chunk_min`` the smallest partial
    prefill chunk worth a slot, ``chunk_bins`` the padded chunk ladder
    (None derives chunk_min * 2^k capped at token_budget), ``moe`` the
    expert-capacity knobs of MoE serving."""

    token_budget: int = 256
    max_running: int = 8
    chunk_min: int = 16
    chunk_bins: Optional[Tuple[int, ...]] = None
    moe: MoEServingConfig = dataclasses.field(default_factory=MoEServingConfig)

    def __post_init__(self):
        if self.moe is None:
            self.moe = MoEServingConfig()
        elif isinstance(self.moe, dict):
            allowed = {f.name for f in dataclasses.fields(MoEServingConfig)}
            unknown = set(self.moe) - allowed
            if unknown:
                raise ConfigError(f"unknown serving.moe config keys {sorted(unknown)} "
                                  f"(allowed: {sorted(allowed)})")
            self.moe = MoEServingConfig(**self.moe)
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
        if "speculative" in d:
            raise _refuse("speculative")
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
    # tensor parallelism: only 1 (one card) is ported
    tensor_parallel: int = 1
    max_batch_size: int = 8
    max_seq_len: int = 2048
    # v1 generate
    max_new_tokens: int = 128
    eos_token_id: int = -1                    # -1 = never stop early
    pad_token_id: int = 0
    # sampling defaults: only greedy decoding (the defaults) is ported
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # "auto" | "xla" | "pallas": "pallas" runs decode rows through the
    # fused decode kernels (QKV+RoPE+append, split-K attention, fused MLP;
    # their plain versions on a CPU engine), "xla" through the layer body
    # over the paged decode kernel; "auto" is "pallas" on the card and
    # "xla" on the CPU
    decode_kernel: str = "auto"
    # weight-only quantization: the layer matrices stored as int8 (8),
    # packed int4 (4) or e4m3 ("fp8") at a group of min(quant_group_size,
    # 256) rows, the unembedding rounded through int8 at flat groups of
    # quant_group_size
    quantize_weights: bool = False
    quant_bits: Any = 8
    quant_group_size: int = 2048
    kv_block_size: int = 64
    num_kv_blocks: int = 256
    # KV pool storage: "bf16" (the serving dtype), or "int8" / "fp8" (e4m3)
    # with an f32 scale per (token, kv head) row; the paged engine only
    kv_cache_dtype: str = "bf16"
    prefix_caching: bool = False
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    # multi-tenant LoRA serving through the paged engine's adapter pool
    adapters: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)

    def __post_init__(self):
        if self.adapters is None:
            self.adapters = AdapterConfig()
        elif isinstance(self.adapters, dict):
            allowed = {f.name for f in dataclasses.fields(AdapterConfig)}
            unknown = set(self.adapters) - allowed
            if unknown:
                raise ConfigError(f"unknown adapters config keys {sorted(unknown)} "
                                  f"(allowed: {sorted(allowed)})")
            self.adapters = AdapterConfig(**self.adapters)
        elif not isinstance(self.adapters, AdapterConfig):
            raise ConfigError(f"adapters must be a dict or AdapterConfig, got "
                              f"{type(self.adapters).__name__}")
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
        self.kv_cache_dtype = _normalize_kv_cache_dtype(self.kv_cache_dtype)
        if not isinstance(self.prefix_caching, bool):
            raise ConfigError(f"prefix_caching must be a bool, got "
                              f"{self.prefix_caching!r}")
        if self.prefix_caching:
            raise _refuse("prefix_caching")
        for name in ("max_batch_size", "max_seq_len", "kv_block_size", "num_kv_blocks",
                     "tensor_parallel", "max_new_tokens"):
            if int(getattr(self, name)) < 1:
                raise ConfigError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.tensor_parallel > 1:
            raise ConfigError(f"tensor_parallel={self.tensor_parallel}: tensor-parallel "
                              "serving is not in the PyTorch port yet (ROADMAP queue A, "
                              "item 12)")
        self.quant_bits = _normalize_quant_bits(self.quant_bits)
        if int(self.quant_group_size) < 1:
            raise ConfigError(f"quant_group_size must be >= 1, got {self.quant_group_size}")
        sampled = sampling_knobs(self.temperature, self.top_k, self.top_p)
        if sampled:
            raise ConfigError(f"{sampled}: sampled decoding is not in the PyTorch port yet; "
                              "it decodes greedily (ROADMAP queue A, item 3)")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "InferenceConfig":
        """Build from a JAX-format config dict. Keys of features this slice
        does not port raise, naming the ROADMAP item; other unknown keys
        raise too."""
        d = dict(d or {})
        if "quant" in d:
            q = d.pop("quant")
            if isinstance(q, dict):
                d["quantize_weights"] = bool(q.get("enabled", False))
                if "bits" in q:
                    d["quant_bits"] = q["bits"]   # normalised and validated in __post_init__
        dtype = d.get("dtype")
        if dtype is not None and str(dtype).replace("torch.", "") == "int8":
            # the reference's dtype=torch.int8 means int8-quantized weights:
            # weight-only quantization with bf16 compute, as in the JAX package
            d["dtype"] = "bfloat16"
            d["quantize_weights"] = True
        for key in _UNSUPPORTED:
            if key == "prefix_caching":
                continue   # validated by value in __post_init__
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
