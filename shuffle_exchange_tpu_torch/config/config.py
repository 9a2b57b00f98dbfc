"""The training config tree of the PyTorch port — DeepSpeed-JSON compatible.

Counterpart of ``shuffle_exchange_tpu/config/config.py`` for the sections
one card's training step reads: the batch-size triangle, ``fp16``,
``bf16``, ``zero_optimization`` (the stage), ``optimizer``,
``scheduler``, ``gradient_clipping``, ``resilience.nonfinite_policy``, with
the JAX package's field names, defaults, aliases, legacy spellings and
validation. A section the port does not run yet (offload, ZeRO++, mesh
axes above 1, pipeline, LoRA, shuffle_exchange, monitors, checkpoints ...)
is accepted at its inert default and raises a ``ConfigError`` naming its
ROADMAP item when it is switched on; nothing is silently ignored.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch

from ..utils.logging import logger
from .config_utils import ConfigError, ConfigModel, config_field

# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@dataclass
class FP16Config(ConfigModel):
    enabled: bool = config_field(False)
    auto_cast: bool = config_field(False)
    loss_scale: float = config_field(0.0, ge=0.0)  # 0 => dynamic
    initial_scale_power: int = config_field(16, ge=0)
    loss_scale_window: int = config_field(1000, gt=0)
    hysteresis: int = config_field(2, ge=1)
    consecutive_hysteresis: bool = config_field(False)
    min_loss_scale: float = config_field(1.0, ge=0.0)
    fp16_master_weights_and_grads: bool = config_field(False)

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclass
class BF16Config(ConfigModel):
    enabled: bool = config_field(False, aliases=("bfloat16",))
    immediate_grad_update: bool = config_field(True)


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------


@dataclass
class OffloadConfig(ConfigModel):
    """device none|cpu|nvme; anything but "none" is ROADMAP queue A, item 12."""

    device: str = config_field("none")
    nvme_path: Optional[str] = config_field(None)
    buffer_count: int = config_field(5, ge=1)
    buffer_size: int = config_field(100_000_000, ge=1)
    max_in_cpu: int = config_field(1_000_000_000, ge=0)
    pin_memory: bool = config_field(False)
    pipeline_read: bool = config_field(False)
    pipeline_write: bool = config_field(False)
    fast_init: bool = config_field(False)
    ratio: float = config_field(1.0, ge=0.0, le=1.0)
    offload_overlap: bool = config_field(False)
    overlap_bucket_mb: int = config_field(128, ge=0)

    @classmethod
    def from_dict(cls, data=None, path=""):
        data = dict(data or {})
        # Legacy boolean shorthand ("cpu_offload": true) means offload-to-CPU.
        if data.pop("enabled", False) and data.get("device", "none") == "none":
            data["device"] = "cpu"
        return super().from_dict(data, path=path)

    def _validate(self, path=""):
        super()._validate(path)
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(f"offload device must be none|cpu|nvme, got {self.device!r}")

    @property
    def enabled(self) -> bool:
        return self.device not in ("none",)


@dataclass
class ZeroConfig(ConfigModel):
    stage: int = config_field(0, ge=0, le=3)
    contiguous_gradients: bool = config_field(True)
    reduce_scatter: bool = config_field(True)
    reduce_bucket_size: int = config_field(500_000_000, ge=0)
    allgather_partitions: bool = config_field(True)
    allgather_bucket_size: int = config_field(500_000_000, ge=0)
    overlap_comm: Optional[bool] = config_field(None)
    load_from_fp32_weights: bool = config_field(True)
    elastic_checkpoint: bool = config_field(False)
    offload_param: OffloadConfig = config_field(default_factory=OffloadConfig)
    offload_optimizer: OffloadConfig = config_field(default_factory=OffloadConfig)
    sub_group_size: int = config_field(1_000_000_000, ge=0)
    cpu_offload: Optional[bool] = config_field(None, deprecated=True, new_param="offload_optimizer")
    stage3_max_live_parameters: int = config_field(1_000_000_000, ge=0)
    stage3_max_reuse_distance: int = config_field(1_000_000_000, ge=0)
    stage3_prefetch_bucket_size: int = config_field(50_000_000, ge=0)
    stage3_param_persistence_threshold: int = config_field(100_000, ge=0)
    stage3_model_persistence_threshold: int = config_field(9_223_372_036_854_775_807, ge=0)
    stage3_gather_16bit_weights_on_model_save: bool = config_field(
        False, aliases=("stage3_gather_fp16_weights_on_model_save",))
    stage3_use_all_reduce_for_fetch_params: bool = config_field(False)
    zero_hpz_partition_size: int = config_field(1, ge=1)
    zero_quantized_weights: bool = config_field(False)
    zero_quantized_nontrainable_weights: bool = config_field(False)
    zero_quantized_gradients: bool = config_field(False)
    mics_shard_size: int = config_field(-1)
    mics_hierarchical_params_gather: bool = config_field(False)
    memory_efficient_linear: bool = config_field(True)
    round_robin_gradients: bool = config_field(False)
    ignore_unused_parameters: bool = config_field(True)
    legacy_stage1: bool = config_field(False)
    override_module_apply: bool = config_field(True)
    log_trace_cache_warnings: bool = config_field(False)

    @property
    def effective_overlap_comm(self) -> bool:
        return self.overlap_comm if self.overlap_comm is not None else (self.stage == 3)

    def unported(self):
        """(what, ROADMAP item) of every switched-on knob the port lacks."""
        later = "ROADMAP queue A, item 12"
        checks = [
            (self.offload_optimizer.enabled, "zero_optimization.offload_optimizer (the host "
             "optimizer tier)"),
            (self.offload_param.enabled, "zero_optimization.offload_param"),
            (self.zero_quantized_weights or self.zero_quantized_nontrainable_weights
             or self.zero_quantized_gradients, "the ZeRO++ quantized wire (zero_quantized_*)"),
            (self.zero_hpz_partition_size > 1, "zero_hpz_partition_size > 1 (hpZ)"),
            (self.mics_shard_size > 0, "mics_shard_size > 0 (MiCS)"),
        ]
        return [(what, later) for on, what in checks if on]


@dataclass
class OptimizerConfig(ConfigModel):
    type: str = config_field("AdamW")
    params: Dict[str, Any] = config_field(default_factory=dict)
    legacy_fusion: bool = config_field(False)


@dataclass
class SchedulerConfig(ConfigModel):
    type: Optional[str] = config_field(None)
    params: Dict[str, Any] = config_field(default_factory=dict)


@dataclass
class ActivationCheckpointingConfig(ConfigModel):
    """Parsed and validated as in the JAX package, where the engine does not
    read it either: the model's own ``remat`` / ``remat_policy`` decide."""

    partition_activations: bool = config_field(False)
    contiguous_memory_optimization: bool = config_field(False)
    cpu_checkpointing: bool = config_field(False)
    number_checkpoints: Optional[int] = config_field(None)
    synchronize_checkpoint_boundary: bool = config_field(False)
    profile: bool = config_field(False)
    policy: str = config_field("dots_saveable")
    enabled: bool = config_field(False)

    VALID_POLICIES = ("none", "full", "dots_saveable", "nothing_saveable",
                      "dots_with_no_batch_dims_saveable", "offload_kv_host",
                      "save_attn_seams", "save_ffn", "save_flash_lse")

    def _validate(self, path=""):
        super()._validate(path)
        if self.policy not in self.VALID_POLICIES:
            raise ConfigError(f"activation_checkpointing.policy must be one of "
                              f"{self.VALID_POLICIES}, got {self.policy!r}")


@dataclass
class ResilienceConfig(ConfigModel):
    """``nonfinite_policy``: what the step does when the loss or the grad
    norm comes out non-finite (beyond the fp16 overflow skip): ``skip``
    drops the update, ``off`` applies it. ``rollback`` and ``raise`` need
    the checkpoint layer (ROADMAP queue A, item 7), as do the other knobs
    when moved from their defaults."""

    preemption_save: bool = config_field(True)
    save_dir: Optional[str] = config_field(None)
    keep_last_n: int = config_field(0, ge=0)
    nonfinite_policy: str = config_field("skip")
    watchdog_timeout_s: float = config_field(0.0, ge=0.0)

    def _validate(self, path=""):
        super()._validate(path)
        if self.nonfinite_policy not in ("off", "skip", "rollback", "raise"):
            raise ConfigError("resilience.nonfinite_policy must be off|skip|rollback|raise, "
                              f"got {self.nonfinite_policy!r}")

    def unported(self):
        later = "ROADMAP queue A, item 7"
        checks = [
            (self.nonfinite_policy in ("rollback", "raise"),
             f"resilience.nonfinite_policy={self.nonfinite_policy!r} (needs the checkpoint "
             "and resilience layer)"),
            (self.save_dir is not None, "resilience.save_dir"),
            (self.keep_last_n > 0, "resilience.keep_last_n"),
            (self.watchdog_timeout_s > 0, "resilience.watchdog_timeout_s"),
        ]
        return [(what, later) for on, what in checks if on]


@dataclass
class MeshConfig(ConfigModel):
    """Sizes of the named mesh axes; one card runs with every axis at 1
    (``data`` -1 absorbs the one device)."""

    data: int = config_field(-1)
    fsdp: int = config_field(1, ge=1)
    tensor: int = config_field(1, ge=1)
    expert: int = config_field(1, ge=1)
    seq: int = config_field(1, ge=1)
    pipe: int = config_field(1, ge=1)


# ---------------------------------------------------------------------------
# Sections the port does not run yet: inert defaults and ROADMAP items
# ---------------------------------------------------------------------------

#: section -> (ROADMAP item, the inert defaults of its keys). A section is
#: switched on when "enabled" is true or a key differs from its default.
_UNPORTED_SECTIONS: Dict[str, tuple] = {
    "zeropp": ("item 12", {"hierarchical_axes": None, "bucket_mb": 32, "group_size": 2048}),
    "data_types": ("item 14", {"grad_accum_dtype": None}),
    "tensorboard": ("item 14", None), "wandb": ("item 14", None),
    "csv_monitor": ("item 14", None), "comet": ("item 14", None),
    "flops_profiler": ("item 14", None), "comms_logger": ("item 14", None),
    "elasticity": ("item 14", None), "autotuning": ("item 14", None),
    "progressive_layer_drop": ("item 14", None),
    "checkpoint": ("item 7", {"tag_validation": "Warn", "load_universal": False,
                              "use_node_local_storage": False,
                              "parallel_write": {"pipeline_stage": False}, "writer": "torch",
                              "async_save": False}),
    "lora": ("item 10", None), "optimized_linear": ("item 10", None),
    "shuffle_exchange": ("item 11", None),
    "tensor_parallel": ("item 12", {"autotp_size": 0, "tp_size": 1, "tp_grain_size": 64}),
    "autotp": ("item 12", {"autotp_size": 0, "tp_size": 1, "tp_grain_size": 64}),
    "context_parallel": ("item 12", {"degree": 1, "kv_chunk": 1024, "use_kernel": "auto"}),
    "pipeline": ("item 12", {"stages": 0, "micro_batches": 0, "partition_method": "uniform",
                             "partition": "uniform", "activation_checkpoint_interval": 0,
                             "seed_layers": False, "pipe_partitioned": True,
                             "grad_partitioned": True}),
    "compression_training": ("item 14", {}), "data_efficiency": ("item 14", {}),
    "curriculum_learning": ("item 14", {}), "hybrid_engine": ("item 13", None),
    "amp": ("item 14", {}), "aio": ("item 12", {}), "nebula": ("item 7", {}),
    "compile": ("item 14", {}), "timers": ("item 14", {}),
}

#: scalar root keys that must stay at their inert value
_UNPORTED_SCALARS = {
    "sequence_parallel_size": (1, "item 12"), "pipeline_parallel_size": (1, "item 12"),
    "wall_clock_breakdown": (False, "item 14"), "memory_breakdown": (False, "item 14"),
    "dump_state": (False, "item 14"), "communication_data_type": (None, "item 12"),
    "disable_allgather": (False, "item 12"), "graph_harvesting": (False, "item 14"),
}


def _section_is_on(value, defaults) -> bool:
    if value is None or value is False:
        return False
    if value is True:
        return True
    if not isinstance(value, dict):
        return True
    if defaults is None:                      # sections with an "enabled" switch
        return bool(value.get("enabled", False))
    return any(k == "enabled" and v or k != "enabled" and defaults.get(k, object()) != v
               for k, v in value.items())


def _refuse_unported(data: Dict[str, Any]) -> None:
    for key, (item, defaults) in _UNPORTED_SECTIONS.items():
        if key in data and _section_is_on(data[key], defaults):
            raise ConfigError(f"config section {key!r} is switched on, but the PyTorch port "
                              f"does not run it yet: ROADMAP queue A, {item}")
    for key, (inert, item) in _UNPORTED_SCALARS.items():
        if key in data and data[key] not in (inert, None):
            raise ConfigError(f"config key {key!r}={data[key]!r} asks for what the PyTorch "
                              f"port does not run yet: ROADMAP queue A, {item}")


# ---------------------------------------------------------------------------
# Root config
# ---------------------------------------------------------------------------

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"


@dataclass
class SXConfig(ConfigModel):
    """Root config. Construct via ``SXConfig.load(path_or_dict, world_size)``."""

    train_batch_size: Optional[int] = config_field(None, gt=0)
    train_micro_batch_size_per_gpu: Optional[int] = config_field(None, gt=0)
    gradient_accumulation_steps: Optional[int] = config_field(None, gt=0)
    steps_per_print: int = config_field(10, gt=0)
    prescale_gradients: bool = config_field(False)
    gradient_predivide_factor: float = config_field(1.0, gt=0.0)
    gradient_clipping: float = config_field(0.0, ge=0.0)
    sparse_gradients: bool = config_field(False)
    seed: int = config_field(1234)
    zero_allow_untested_optimizer: bool = config_field(True)
    zero_force_ds_cpu_optimizer: bool = config_field(True)

    fp16: FP16Config = config_field(default_factory=FP16Config)
    bf16: BF16Config = config_field(default_factory=BF16Config, aliases=("bfloat16",))
    zero_optimization: ZeroConfig = config_field(default_factory=ZeroConfig)
    # None (absent section or explicit null) means "client supplies the
    # optimizer", exactly like the reference's initialize(optimizer=...).
    optimizer: Optional[OptimizerConfig] = config_field(None, model=OptimizerConfig)
    scheduler: SchedulerConfig = config_field(default_factory=SchedulerConfig)
    activation_checkpointing: ActivationCheckpointingConfig = config_field(
        default_factory=ActivationCheckpointingConfig)
    resilience: ResilienceConfig = config_field(default_factory=ResilienceConfig)
    mesh: MeshConfig = config_field(default_factory=MeshConfig)

    @classmethod
    def from_dict(cls, data=None, path=""):
        data = dict(data or {})
        _refuse_unported(data)
        # the unported sections were at their inert defaults: drop them so
        # the unknown-key warning stays for real typos
        for key in (*_UNPORTED_SECTIONS, *_UNPORTED_SCALARS):
            data.pop(key, None)
        return super().from_dict(data, path=path)

    @classmethod
    def load(cls, config: Union[str, os.PathLike, Dict[str, Any], None],
             world_size: int = 1) -> "SXConfig":
        if config is None:
            config = {}
        if isinstance(config, (str, os.PathLike)):
            if not os.path.exists(config):
                raise ConfigError(f"Config file not found: {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ConfigError(f"Expected config dict or path, got {type(config).__name__}")
        obj = cls.from_dict(config)
        obj._refuse_unported_values(world_size)
        obj._resolve_batch_sizes(world_size)
        obj._sanity_check()
        return obj

    def _refuse_unported_values(self, world_size: int) -> None:
        for what, item in (*self.zero_optimization.unported(), *self.resilience.unported()):
            raise ConfigError(f"{what} is not in the PyTorch port yet: {item}")
        m = self.mesh
        if any(v > 1 for v in (m.data, m.fsdp, m.tensor, m.expert, m.seq, m.pipe)):
            raise ConfigError(f"mesh axes above 1 ({m.to_dict()}) are not in the PyTorch port "
                              "yet: ROADMAP queue A, item 12")
        if world_size != 1:
            raise ConfigError(
                f"world size {world_size}: the PyTorch port trains on one card so far; ZeRO "
                "sharding over torch.distributed ranks is ROADMAP queue A, item 5")
        if self.sparse_gradients:
            raise ConfigError("sparse_gradients is not supported: gradients are reduced dense "
                              "(the JAX package rejects the flag as well) — remove the flag")

    @property
    def model_parallel_size(self) -> int:
        """Axes that do NOT consume batch: pipe × tensor × seq × expert."""
        m = self.mesh
        return max(1, m.pipe * m.tensor * m.seq * m.expert)

    def _resolve_batch_sizes(self, world_size: int) -> None:
        """train = micro × gas × dp_world; infer any single missing value
        (the reference's ``_configure_train_batch_size`` / ``_batch_assertion``)."""
        self.world_size = max(1, world_size)
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if self.world_size % self.model_parallel_size:
            raise ConfigError(
                f"World size {self.world_size} not divisible by model-parallel axes "
                f"product {self.model_parallel_size} (mesh={self.mesh.to_dict()})")
        ws = max(1, self.world_size // self.model_parallel_size)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * ws)
        elif train is not None and gas is not None:
            micro = train // (gas * ws)
        elif micro is not None:
            gas = gas or 1
            train = micro * gas * ws
        elif train is not None:
            gas = 1
            micro = train // ws
        else:
            raise ConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")
        self.train_batch_size, self.train_micro_batch_size_per_gpu = train, micro
        self.gradient_accumulation_steps = gas
        if train <= 0 or micro <= 0 or gas <= 0:
            raise ConfigError(f"Batch sizes must be >0: train={train} micro={micro} gas={gas}")
        if train != micro * gas * ws:
            raise ConfigError(
                f"Check batch related parameters. train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step * world_size "
                f"{train} != {micro} * {gas} * {ws}")

    def _sanity_check(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16.enabled and self.fp16.fp16_master_weights_and_grads:
            raise ConfigError("fp16_master_weights_and_grads requires optimizer offload, which "
                              "is not in the PyTorch port yet: ROADMAP queue A, item 12")

    @property
    def train_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    def print_config(self) -> None:
        logger.info("SXConfig:\n" + self.dump())
