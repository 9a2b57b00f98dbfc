from .config import (
    ActivationCheckpointingConfig,
    BF16Config,
    FP16Config,
    MeshConfig,
    OffloadConfig,
    OptimizerConfig,
    ResilienceConfig,
    SchedulerConfig,
    SXConfig,
    ZeroConfig,
)
from .config_utils import ConfigError, ConfigModel

__all__ = ["ActivationCheckpointingConfig", "BF16Config", "ConfigError", "ConfigModel",
           "FP16Config", "MeshConfig", "OffloadConfig", "OptimizerConfig", "ResilienceConfig",
           "SXConfig", "SchedulerConfig", "ZeroConfig"]
