from .config_utils import ConfigError

__all__ = ["ConfigError"]
