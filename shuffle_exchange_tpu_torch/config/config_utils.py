"""Configuration errors (counterpart of the JAX package's
``config/config_utils.py``)."""


class ConfigError(Exception):
    """Raised for invalid or not-yet-supported configuration."""
